from .test import InferenceRunner

__all__ = ['InferenceRunner']
