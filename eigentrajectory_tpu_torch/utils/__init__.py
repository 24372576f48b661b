from .profiling import StepTimer, start_trace, stop_trace, trace_annotation
