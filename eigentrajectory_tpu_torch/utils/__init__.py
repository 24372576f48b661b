from .misc import print_arguments
from .profiling import StepTimer, count, counters, span
