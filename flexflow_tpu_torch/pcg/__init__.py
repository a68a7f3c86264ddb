from .graph import Edge, Graph, OpNode

__all__ = ["Edge", "Graph", "OpNode"]
