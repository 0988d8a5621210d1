from .synthetic import powerlaw_community_edges, random_node_graph, sbm_arxiv_like

__all__ = ["powerlaw_community_edges", "random_node_graph", "sbm_arxiv_like"]
