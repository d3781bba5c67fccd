"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/utils/__init__.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Foundation layer: config, logging, caching, perf monitoring, file I/O.

TPU-native counterpart of the reference's ``utils.py`` (L0 in SURVEY.md §1).
Pure host-side Python — no device code lives here.
"""

from .config import Config, get_config
from .logging import Logger, get_logger
from .cache import CacheManager
from .perf import PerformanceMonitor
from .files import FileManager
from .paths import SmartPathResolver
from .dataproc import DataProcessor

__all__ = [
    "Config",
    "get_config",
    "Logger",
    "get_logger",
    "CacheManager",
    "PerformanceMonitor",
    "FileManager",
    "SmartPathResolver",
    "DataProcessor",
]
