from .logging import get_logger, log_config, log_test_result
from .pytree import pytree_dataclass, static_field
from .timer import Timer
