from .synthetic import random_node_graph, sbm_arxiv_like

__all__ = ["random_node_graph", "sbm_arxiv_like"]
