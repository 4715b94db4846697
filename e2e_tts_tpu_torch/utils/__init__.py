from .logging import ServeLogger
from .storage import HttpStorage, LocalStorage, default_storage
