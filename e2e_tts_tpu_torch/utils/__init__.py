from .logging import AcousticLogger, E2ELogger, ScalarWriter, ServeLogger
from .metrics import DspProxyScorer, evaluate_directory, make_scorer
from .profiling import RtfReport, device_trace, engine_cache_stats, measure_rtf
from .params import get_param_num, param_summary, show_params
from .storage import HttpStorage, LocalStorage, default_storage
from .prefetch import prefetch_iterator
from . import tracing
