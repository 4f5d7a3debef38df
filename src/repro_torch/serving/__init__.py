"""The serving tier (batch worker; fleets and streaming come later)."""
from .worker import BatchWorker, StreamRequest

__all__ = ["BatchWorker", "StreamRequest"]
