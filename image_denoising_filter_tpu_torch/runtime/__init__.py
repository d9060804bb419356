from .prefetch import FramePrefetcher  # noqa: F401
from .session import RunResult, Session  # noqa: F401
