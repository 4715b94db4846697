from .ctc import forward_sum_loss
from .length_regulator import (
    average_by_segments,
    durations_to_mel2ph,
    regulate_length,
    sum_by_words,
)
from .masking import sequence_mask
from .mas import monotonic_align
from .pitch import bucketize, f0_to_coarse
