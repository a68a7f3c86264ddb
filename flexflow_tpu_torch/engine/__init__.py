"""Execution-engine helpers of the port (chunk planning)."""

from .chunking import plan_chunks

__all__ = ["plan_chunks"]
