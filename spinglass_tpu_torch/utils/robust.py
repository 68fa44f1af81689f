"""Retry / robustness decorators (reference utils/robust_error_handling.py:
215-267 @robust_operation and utils/robust_execution.py:70-431).

Copied from ``spinglass_tpu.utils.robust``: the port imports nothing of
the JAX package."""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional, Tuple, Type

from spinglass_tpu_torch.utils.logging import get_logger


def robust_operation(max_retries: int = 3, backoff: float = 0.5,
                     exceptions: Tuple[Type[Exception], ...] = (Exception,),
                     component: str = "", operation: str = "",
                     fallback: Optional[Callable] = None):
    """Retry with exponential backoff; optional fallback on exhaustion."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            log = get_logger()
            last: Optional[Exception] = None
            for attempt in range(max_retries + 1):
                try:
                    return fn(*args, **kwargs)
                except exceptions as e:
                    last = e
                    if attempt < max_retries:
                        wait = backoff * (2 ** attempt)
                        log.warning(
                            f"{component or fn.__module__}."
                            f"{operation or fn.__name__} attempt "
                            f"{attempt + 1}/{max_retries + 1} failed: {e}; "
                            f"retrying in {wait:.1f}s")
                        time.sleep(wait)
            if fallback is not None:
                log.warning(
                    f"{operation or fn.__name__}: falling back after "
                    f"{max_retries + 1} failures")
                return fallback(*args, **kwargs)
            raise last  # type: ignore[misc]

        return wrapper

    return decorator
