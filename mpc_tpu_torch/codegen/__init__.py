from .c_export import export_c, compile_and_load

__all__ = ["export_c", "compile_and_load"]
