from .logging import AcousticLogger, E2ELogger, ScalarWriter, ServeLogger
from .prefetch import prefetch_iterator
from .storage import HttpStorage, LocalStorage, default_storage
