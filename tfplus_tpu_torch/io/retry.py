"""Shared transient-failure retry policy for the remote-storage clients.

One place for the policy the reference's SDK clients implement internally:
connection-level errors and transient 5xx back off exponentially and
re-attempt, bounded. Used by :mod:`tfplus_tpu_torch.io.object_store` (which
re-signs per attempt inside ``attempt_fn``) and :mod:`tfplus_tpu_torch.io.dfs`
(idempotent legs only — the callers decide idempotency).

A copy of ``tfplus_tpu/io/retry.py`` (stdlib only; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import http.client
import time
from typing import Callable, Optional, TypeVar

RETRY_ATTEMPTS = 4
RETRY_BASE_S = 0.05
RETRY_STATUS = (500, 502, 503, 504)

T = TypeVar("T")


def retry_transient(attempt_fn: Callable[[], T], *, describe: str,
                    status_of: Optional[Callable[[T], int]] = None,
                    attempts: int = RETRY_ATTEMPTS) -> T:
    """Run ``attempt_fn`` up to ``attempts`` times.

    Retries on ``http.client.HTTPException`` / ``OSError`` (connection
    errors) and, when ``status_of`` is given, on transient 5xx statuses —
    except on the LAST attempt, whose result is returned as-is so callers
    surface the real status. Only call this for attempts that are safe to
    replay (``attempt_fn`` must rebuild time-sensitive state per call,
    e.g. request signatures).
    """
    last: Optional[Exception] = None
    for i in range(attempts):
        if i:
            time.sleep(min(RETRY_BASE_S * (2 ** (i - 1)), 1.0))
        try:
            res = attempt_fn()
        except (http.client.HTTPException, OSError) as e:
            last = e
            continue
        if (status_of is not None and status_of(res) in RETRY_STATUS
                and i + 1 < attempts):
            last = IOError(f"HTTP {status_of(res)}")
            continue
        return res
    raise IOError(f"{describe}: {attempts} attempts failed: {last!r}")
