from .postprocess import align_foreground

__all__ = ['align_foreground']
