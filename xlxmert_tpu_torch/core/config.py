"""Model configuration (port of xlxmert_tpu/core/config.py::LxmertConfig).

The backbone shape. `yaml` is imported only inside `from_yaml`, so the
package loads on a host without it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LxmertConfig:
    """LXMERT backbone shape; defaults match HF `LxmertConfig` and the
    reference recipe (9 language, 5 visual, 5 cross layers at 768)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    l_layers: int = 9
    x_layers: int = 5
    r_layers: int = 5
    visual_feat_dim: int = 2048
    visual_pos_dim: int = 4
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    num_qa_labels: int = 9500
    num_object_labels: int = 1600
    num_attr_labels: int = 400
    num_clusters: int = 10000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def clustering(self) -> bool:
        return self.num_clusters > 0

    @classmethod
    def from_yaml(cls, path: str) -> "LxmertConfig":
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
