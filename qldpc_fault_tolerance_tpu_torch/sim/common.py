"""Shared Monte-Carlo helpers of the simulators."""
from __future__ import annotations

import numpy as np

__all__ = ["wer_single_shot", "ShotBatcher"]


def wer_single_shot(error_count: int, num_run: int, K: int):
    """WER + error bar for single-shot decoding."""
    logical_error_rate = error_count / num_run
    logical_error_rate_eb = np.sqrt(
        (1 - logical_error_rate) * logical_error_rate / num_run
    )
    word_error_rate = 1.0 - (1 - logical_error_rate) ** (1 / K)
    word_error_rate_eb = (
        logical_error_rate_eb * ((1 - logical_error_rate_eb) ** (1 / K - 1)) / K
    )
    return word_error_rate, word_error_rate_eb


class ShotBatcher:
    """Splits a shot budget into batches of one fixed size.

    The trailing partial batch runs at full size and the surplus shots are
    counted in (they are i.i.d., so extra samples only tighten the
    estimate)."""

    def __init__(self, num_shots: int, batch_size: int):
        self.batch_size = int(batch_size)
        self.num_batches = max(1, -(-int(num_shots) // self.batch_size))

    @property
    def total(self) -> int:
        return self.num_batches * self.batch_size
