from .executor import RTStats, rt_run_exported, build_executor

__all__ = ["RTStats", "rt_run_exported", "build_executor"]
