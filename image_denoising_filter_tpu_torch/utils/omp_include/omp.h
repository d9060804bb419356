/* The one OpenMP declaration native/idf_native.cpp uses, for a compiler
 * that takes -fopenmp but ships no omp.h (route c of utils/native.py).
 * The definition comes from the libgomp.so.1 the library links by path. */
#ifndef IDF_TORCH_OMP_H
#define IDF_TORCH_OMP_H
#ifdef __cplusplus
extern "C" {
#endif
int omp_get_max_threads(void);
#ifdef __cplusplus
}
#endif
#endif
