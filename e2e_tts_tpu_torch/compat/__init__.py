from .torch_import import (
    convert_acoustic,
    convert_hifigan,
    load_acoustic,
    load_torch_state_dict,
    load_vocoder,
)
