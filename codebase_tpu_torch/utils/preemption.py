"""Preemption-safe shutdown: catch SIGTERM, checkpoint, exit cleanly.

A preempted machine gets SIGTERM and a grace window. The guard turns that
into "save the full train state at the next chunk boundary and stop", which
with `resume=auto` (`utils/checkpoint.resolve_resume`) makes kill -TERM and
a relaunch an exact continuation.

The handler only sets a flag: the host loops read it after each chunk of
train iterations, where the train state is whole. Python runs signal
handlers in the main thread between bytecodes, so the flag is seen as soon
as the chunk in flight returns.
"""

from __future__ import annotations

import signal


class PreemptionGuard:
    """Install a SIGTERM handler that records the request instead of dying.

    Use as a context manager so the previous handler is restored:

        with PreemptionGuard() as guard:
            while ...:
                train a chunk
                if guard.triggered:
                    save_checkpoint(...); break
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous = {}
        self.triggered = False

    def _handler(self, signum, frame):
        self.triggered = True

    def __enter__(self):
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        return False
