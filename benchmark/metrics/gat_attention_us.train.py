"""gat_attention_us.train: device µs an epoch in the GAT's attention phase (edge logits, LeakyReLU, the edge softmax, their backward and segment sums), its nested reconstructs, truncations and draws excluded (moves epoch_ms)."""

from benchmark.harness import phases


def read(r):
    return phases.phase_us(r, "train", "attention")
