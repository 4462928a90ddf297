"""Request deadlines (the minimal part of ``predictionio_tpu/common/
resilience.py`` the serving slice needs: :class:`Deadline` and
:class:`DeadlineExceeded`). Retry policies, breakers and the ambient
deadline scope come with the slices that use them."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed; subclasses TimeoutError so existing
    timeout handling (batched-query waiters) keeps working."""


@dataclass(frozen=True)
class Deadline:
    """Absolute monotonic deadline. Construct via :meth:`after_ms`."""

    at: float  # time.monotonic() timestamp

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(time.monotonic() + ms / 1e3)

    def remaining_s(self) -> float:
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining_s() <= 0

    @staticmethod
    def min(*deadlines: Optional["Deadline"]) -> Optional["Deadline"]:
        live = [d for d in deadlines if d is not None]
        if not live:
            return None
        return min(live, key=lambda d: d.at)
