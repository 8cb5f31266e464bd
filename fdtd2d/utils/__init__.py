from fdtd2d.utils.cache import enable_compilation_cache
from fdtd2d.utils.metrics import Timer, throughput_gcells, trace_profile

__all__ = ["Timer", "throughput_gcells", "trace_profile",
           "enable_compilation_cache"]
