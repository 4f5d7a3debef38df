"""The synthetic token pipeline of the LM training path."""
from .pipeline import TokenPipeline, synth_tokens

__all__ = ["TokenPipeline", "synth_tokens"]
