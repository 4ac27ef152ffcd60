"""Typed configuration (port of xlxmert_tpu/core/config.py's
LxmertConfig, TrainConfig and FinetuneConfig).

The backbone shape and the trainer knobs, with the JAX package's fields
and defaults, so a config file written by either package reads in the
other. `yaml` is imported only inside `save` and `from_yaml`, so the
package loads on a host without it. `rng_impl` chooses JAX's PRNG
there; the port draws dropout from a `torch.Generator` and accepts the
field without effect, as the JAX CLI accepts `--multiGPU`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


class _YamlMixin:
    def save(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f,
                           default_flow_style=False)

    @classmethod
    def from_yaml(cls, path: str):
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LxmertConfig(_YamlMixin):
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


@dataclass(frozen=True)
class TrainConfig(_YamlMixin):
    """Shared trainer knobs (reference param.py:61-279; defaults = the
    pretrain.bash recipe)."""

    # optimization
    optim: str = "adamw"
    lr: float = 1e-4
    batch_size: int = 256
    epochs: int = 20
    warmup_ratio: float = 0.05
    weight_decay: float = 0.01
    clip_grad_norm: float = 1.0
    adam_eps: float = 1e-6
    update_freq: int = 1  # gradient accumulation (tasks/vqa.py:152-159)
    seed: int = 9595

    # bf16 compute with fp32 parameters; --fp32 turns it off
    mixed_precision: bool = True
    # JAX's PRNG choice; no effect in the port (see the module docstring)
    rng_impl: str = "rbg"

    # data
    train: str = "mscoco_train,mscoco_nominival,vgnococo"
    valid: str = "mscoco_minival"
    max_text_length: int = 20
    train_topk: int = -1
    valid_topk: int = -1
    num_workers: int = 4

    # visual input geometry (param.py:145-147)
    grid_model: bool = True
    grid_size: int = 8
    feat_dim: int = 2048
    n_boxes: int = 36

    # clustering / visual vocab (param.py:163-177)
    clustering: bool = True
    num_clusters: int = 10000
    encoder: str = "maskrcnn"
    cluster_src: str = "mscoco_train"
    kmeans_iterations: int = 20

    # pretraining task mix (pretrain.bash:13-18)
    task_mask_lm: bool = True
    task_obj_predict: bool = True
    task_matched: bool = True
    task_qa: bool = False
    visual_losses: str = "obj"  # comma-separated from {obj, attr, feat}
    word_mask_rate: float = 0.15
    obj_mask_rate: float = 0.15
    vis_mask_predict: bool = True
    square_mask: bool = False
    vis_mask_COCO_only: bool = False
    vis_mask_COCOVG_only: bool = True
    target_obj_id: bool = False
    feed_exact_feat: bool = False
    target_exact_feat: bool = False

    # io
    output: str = "snap/pretrain"
    load: Optional[str] = None
    load_lxmert: Optional[str] = None
    load_lxmert_qa: Optional[str] = None
    from_scratch: bool = False
    bert_weights: Optional[str] = None
    save_full_state: bool = False
    comment: str = ""

    # distribution (the JAX package's device mesh; one device here)
    distributed: bool = True
    mesh_shape: Tuple[int, ...] = ()
    mesh_axis_names: Tuple[str, ...] = ("data",)

    # debug / smoke (param.py:142-143,214,237)
    dry: bool = False
    debug: bool = False
    test_only: bool = False

    # on-host data paths
    data_root: str = "data"

    def __post_init__(self):
        if self.clustering and not self.grid_model:
            raise ValueError(
                "clustering pretraining requires grid_model=True "
                "(--grid_model): cluster ids are grid_size^2 grids")
        if self.square_mask and not self.grid_model:
            raise ValueError(
                "--square_mask is a grid-pattern mask: it requires "
                "grid_model=True (use the bernoulli/uniform-count masks "
                "on the bbox path)")
        if self.target_obj_id and self.grid_model and not self.clustering:
            raise ValueError(
                "--target_obj_id needs detector obj ids, which only the "
                "bbox h5 provides: drop --grid_model or --target_obj_id")

    @property
    def n_grids(self) -> int:
        return self.grid_size ** 2

    @property
    def n_vis(self) -> int:
        """Visual tokens per image: grid cells, or n_boxes on the bbox
        path (reference lxmert_data.py:225-231)."""
        return self.grid_size ** 2 if self.grid_model else self.n_boxes

    @property
    def visual_loss_keys(self) -> Tuple[str, ...]:
        return tuple(k for k in self.visual_losses.split(",") if k)

    @property
    def mask_modalities(self) -> Tuple[str, ...]:
        """The task round-robin (lxmert_pretrain.py:777-805)."""
        return tuple(task for task, on in (
            ("vis_mask", self.task_obj_predict),
            ("word_mask", self.task_mask_lm),
            ("matched", self.task_matched)) if on)


@dataclass(frozen=True)
class FinetuneConfig(TrainConfig):
    """VQA/GQA/NLVR2 fine-tuning (tasks/{vqa,gqa,nlvr2}.py __main__
    defaults)."""

    task: str = "vqa"
    # eval/test prediction through the static-calibrated int8 engine
    serve_int8: bool = False
    lr: float = 5e-5
    epochs: int = 10
    batch_size: int = 32
    task_mask_lm: bool = False
    task_obj_predict: bool = False
    task_matched: bool = False
    task_qa: bool = True
    vis_mask_predict: bool = False
    train: str = "train,nominival"
    valid: str = "minival"
    test: Optional[str] = None
