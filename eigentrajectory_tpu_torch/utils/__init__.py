from .misc import print_arguments
from .profiling import StepTimer, start_trace, stop_trace, trace_annotation
