from cognn_tpu_torch.graph.partition import PartyGraph, build_party_graph  # noqa: F401
