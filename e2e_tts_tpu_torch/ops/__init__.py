from .length_regulator import durations_to_mel2ph, regulate_length
from .masking import sequence_mask
from .pitch import bucketize, f0_to_coarse
