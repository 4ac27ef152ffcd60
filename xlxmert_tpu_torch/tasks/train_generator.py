"""SPADE GAN trainer (port of xlxmert_tpu/tasks/train_generator.py):
hinge adversarial + ACGAN cluster CE + perceptual feature loss +
discriminator feature matching.

The reference's `image_generator/src/trainer.py` is missing from its
repo (main.py:25 imports it); the JAX package reconstructs the recipe
from configs.py:119-134 + train_generator.bash, and this port
reproduces that reconstruction:
  hinge GAN (lambda=1), ACGAN per-cell 10000-way cluster CE (lambda=1),
  perceptual feature L1 via a frozen ResNet encoder over layer1..4
  (lambda=10, only when encoder weights are given), D feature matching
  L1 (lambda=10); Adam(beta1=0), g_lr 4e-4 / d_lr 1e-4, eps 1e-7
  (configs.py:57-75), as optax.adam (core/optim.Adam).

The steps' semantics are the JAX package's:
  - G-step: G trains with one power iteration per spectral norm and
    noise; D is applied with its stored u, v and no update; D(real) is a
    no-gradient target for feature matching; `step` advances;
  - D-step: G's forward is in training mode (noise, batch-norm
    statistics updated) with its stored u, v and no gradient; D(real)
    runs one power iteration and D(fake) reuses the updated u, v; `step`
    does not advance.
Under mixed precision the compute type is bf16; parameters, losses,
norms and the ACGAN logits stay fp32, as in the JAX modules.

The noise draws from the state's `torch.Generator` on the device (the
JAX package folds the step into a PRNG key; the bits differ). The
state's trees convert to and from the JAX package's layout
(`state_to_tree`, `restore_state`: `serialization.to_state_dict` of its
GanState), so a checkpoint written by either package resumes in the
other.

Data parallelism (parallel/mesh, the JAX package's data mesh): each
rank steps on its own slice of the global batch, the gradients are
averaged over the data group before each Adam step, the metrics are the
global batch's, and the "batch" SPADE norm takes its statistics over the
global batch (models/gan.sync_batch_norm). Data ranks draw their own
noise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from xlxmert_tpu_torch.core.checkpoint import same_layout
from xlxmert_tpu_torch.core.config import GanConfig
from xlxmert_tpu_torch.core.convert import (
    convert_torch_state_dict, flax_to_state_dict,
)
from xlxmert_tpu_torch.core.optim import Adam
from xlxmert_tpu_torch.models.gan import (
    Discriminator, Generator, init_variables, load_variables, render,
    variables_of,
)
from xlxmert_tpu_torch.models.resnet import (
    ResNet, load_variables as load_resnet, normalize_image, resnet50,
)
from xlxmert_tpu_torch.models.gan import sync_batch_norm
from xlxmert_tpu_torch.parallel import mesh as pmesh
from xlxmert_tpu_torch.utils.device import resolve_device


@dataclass
class GanState:
    """The two models (their fp32 parameters are the trained ones; the
    buffers hold the spectral norms' u, v and the batch-norm statistics),
    their optimizers, the noise generator and the G-step count."""

    G: Generator
    D: Discriminator
    opt_g: Adam
    opt_d: Adam
    generator: torch.Generator
    step: int = 0


def hinge_d_loss(real_logit: torch.Tensor, fake_logit: torch.Tensor
                 ) -> torch.Tensor:
    return (torch.relu(1.0 - real_logit).mean()
            + torch.relu(1.0 + fake_logit).mean())


def hinge_g_loss(fake_logit: torch.Tensor) -> torch.Tensor:
    return -fake_logit.mean()


def cluster_ce(cls_logits: torch.Tensor, cluster_ids: torch.Tensor
               ) -> torch.Tensor:
    """Per-cell ACGAN CE: logits (B*H*W, C), ids (B, H*W)."""
    labels = cluster_ids.reshape(-1).long()
    logp = torch.log_softmax(cls_logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def _opt_tree(opt: Adam) -> Dict:
    """optax.adam's state as serialization.to_state_dict writes it:
    (ScaleByAdamState(count, mu, nu), EmptyState())."""
    return {"0": {"count": np.asarray(opt.count, np.int32),
                  "mu": convert_torch_state_dict(opt.mu),
                  "nu": convert_torch_state_dict(opt.nu)},
            "1": {}}


def state_to_tree(state: GanState) -> Dict:
    """The JAX package's `serialization.to_state_dict(GanState)`: step,
    params_g/d, sn_g/d, opt_g/d and stats_g ({} without batch-norm
    SPADEs), numpy leaves."""
    g, d = variables_of(state.G), variables_of(state.D)
    return {"step": np.asarray(state.step, np.int32),
            "params_g": g["params"], "params_d": d["params"],
            "sn_g": g["sn"], "sn_d": d["sn"],
            "opt_g": _opt_tree(state.opt_g), "opt_d": _opt_tree(state.opt_d),
            "stats_g": g.get("batch_stats", {})}


@torch.no_grad()
def restore_state(state: GanState, tree: Dict) -> GanState:
    """Load a tree in `state_to_tree`'s layout (the JAX package's
    GanState) into `state`, in place. The structure must match exactly,
    as the JAX package's restore_state requires (a loud failure when the
    config changed between save and resume)."""
    tree = {k: v for k, v in tree.items() if k != "total_steps"}
    same_layout(state_to_tree(state), tree, "GAN state checkpoint")
    load_variables(state.G, tree["params_g"], tree["sn_g"],
                   tree["stats_g"] or None)
    load_variables(state.D, tree["params_d"], tree["sn_d"])
    for opt, t in ((state.opt_g, tree["opt_g"]), (state.opt_d,
                                                  tree["opt_d"])):
        opt.count = int(np.asarray(t["0"]["count"]))
        for moments, sub in ((opt.mu, t["0"]["mu"]), (opt.nu, t["0"]["nu"])):
            for name, value in flax_to_state_dict(sub).items():
                moments[name] = value.to(opt.params[name].device)
    state.step = int(np.asarray(tree["step"]))
    return state


class GanEngine:
    """The GAN trainer on one device (`device`, the card by default).
    `perceptual_variables`, the frozen ResNet-50's {"params",
    "batch_stats"} in the flax layout, turn the perceptual term on."""

    def __init__(self, cfg: GanConfig,
                 perceptual_variables: Optional[Dict] = None,
                 device="cuda", mesh: Optional[pmesh.Mesh] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = pmesh.only_axes(mesh or pmesh.make_mesh(), ("data",),
                                    "GAN training")
        self.data_group = self.mesh.group("data")
        self.dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        # perceptual encoder: a frozen resnet, active only when its
        # weights are given (nothing is downloaded)
        self.E: Optional[ResNet] = None
        if perceptual_variables is not None:
            self.E = load_resnet(resnet50(self.dtype), perceptual_variables)
            self.E = self.E.to(self.device).eval().requires_grad_(False)

    # -- init -----------------------------------------------------------------
    def build_models(self, n_classes: int
                     ) -> Tuple[Generator, Discriminator]:
        """G and D of the config (uninitialized), D's ACGAN head over
        `n_classes` (the centroid table's rows)."""
        cfg = self.cfg
        G = Generator(emb_dim=cfg.emb_dim, base_dim=cfg.g_base_dim,
                      target_size=cfg.target_size,
                      extra_layers=cfg.extra_layers, init_H=cfg.init_H,
                      init_W=cfg.init_W, use_sn=cfg.SN,
                      codebook_dim=cfg.codebook_dim, norm_type=cfg.norm_type,
                      dtype=self.dtype)
        D = Discriminator(base_dim=cfg.d_base_dim, emb_dim=cfg.emb_dim,
                          target_size=cfg.target_size,
                          extra_layers=cfg.extra_layers, init_H=cfg.init_H,
                          init_W=cfg.init_W, use_sn=cfg.SN, acgan=cfg.ACGAN,
                          n_classes=n_classes, dtype=self.dtype)
        return G, D

    def create_state(self, seed: int, centroids) -> GanState:
        """A fresh state on the engine's device: G and D with the JAX
        modules' initializer distributions from `seed`, fresh Adams, and
        the noise generator seeded with `seed`. The ACGAN head has as
        many classes as `centroids` (n_classes, emb_dim) has rows."""
        G, D = self.build_models(int(centroids.shape[0]))
        g_vars, d_vars = init_variables(G, seed), init_variables(D, seed + 1)
        load_variables(G, g_vars["params"], g_vars.get("sn"),
                       g_vars.get("batch_stats"))
        load_variables(D, d_vars["params"], d_vars.get("sn"))
        G, D = G.to(self.device), D.to(self.device)
        sync_batch_norm(G, self.data_group)
        cfg = self.cfg
        opt_g = Adam(dict(G.named_parameters()), cfg.g_lr, cfg.adam_beta1,
                     cfg.adam_beta2, eps=1e-7)
        opt_d = Adam(dict(D.named_parameters()), cfg.d_lr, cfg.adam_beta1,
                     cfg.adam_beta2, eps=1e-7)
        gen = torch.Generator(device=self.device).manual_seed(
            seed ^ (self.mesh.index("data") * 0x9E3779B1))
        return GanState(G, D, opt_g, opt_d, gen)

    def place(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch (numpy "image" (B, S, S, 3) in [-1, 1], "code"
        (B, H, W, emb_dim), "cluster_id" (B, H*W)) on the device."""
        out = {k: torch.as_tensor(np.asarray(batch[k], np.float32))
               for k in ("image", "code")}
        out["cluster_id"] = torch.as_tensor(
            np.asarray(batch["cluster_id"], np.int64))
        return {k: v.to(self.device, non_blocking=True)
                for k, v in out.items()}

    # -- perceptual feature loss ----------------------------------------------
    def _perceptual(self, fake_img: torch.Tensor, real_img: torch.Tensor
                    ) -> torch.Tensor:
        if self.E is None:
            return torch.zeros((), dtype=torch.float32,
                               device=fake_img.device)
        # images are tanh outputs in [-1,1] -> [0,1] -> ImageNet norm
        f = self.E(normalize_image((fake_img + 1) / 2), return_layers=True)
        with torch.no_grad():
            r = self.E(normalize_image((real_img + 1) / 2),
                       return_layers=True)
        loss = torch.zeros((), dtype=torch.float32, device=fake_img.device)
        for k in ("layer1", "layer2", "layer3", "layer4"):
            loss = loss + (f[k].float() - r[k].float()).abs().mean()
        return loss / 4.0

    # -- steps ----------------------------------------------------------------
    def g_step(self, state: GanState, batch: Dict[str, torch.Tensor],
               centroids: torch.Tensor
               ) -> Tuple[GanState, Dict[str, torch.Tensor]]:
        """One G update; returns the state (updated in place) and its
        metrics (0-d device tensors)."""
        cfg, G, D = self.cfg, state.G, state.D
        real, code, ids = batch["image"], batch["code"], batch["cluster_id"]
        fake = G(code, train=True, update_sn=True, noise=state.generator)
        d_out = D(fake, y=code, centroids=centroids)
        metrics = {}
        if cfg.ACGAN:
            adv, d_layers, cls = d_out
            cls_loss = cluster_ce(cls, ids)
            metrics["g_cls_loss"] = cls_loss
        else:
            adv, d_layers = d_out
            cls_loss = 0.0
        adv_loss = hinge_g_loss(adv)
        # D feature matching against real (no gradient through D(real))
        with torch.no_grad():
            real_layers = D(real, y=code, centroids=centroids,
                            cls_logits=False)[1]
        fm = torch.zeros((), dtype=torch.float32, device=real.device)
        for fl, rl in zip(d_layers, real_layers):
            fm = fm + (fl.float() - rl.float()).abs().mean()
        fm = fm / len(d_layers)
        perc = self._perceptual(fake, real)
        total = (cfg.lambda_adv * adv_loss + cfg.lambda_cls * cls_loss
                 + cfg.lambda_feat_match * fm + cfg.lambda_feat * perc)
        metrics.update(g_adv_loss=adv_loss, g_feat_match=fm,
                       g_perceptual=perc, g_total=total)
        self._update(state.opt_g, total)
        state.step += 1
        return state, pmesh.mean_over(metrics, self.data_group)

    def d_step(self, state: GanState, batch: Dict[str, torch.Tensor],
               centroids: torch.Tensor
               ) -> Tuple[GanState, Dict[str, torch.Tensor]]:
        """One D update; returns the state (updated in place) and its
        metrics (0-d device tensors)."""
        cfg, G, D = self.cfg, state.G, state.D
        real, code, ids = batch["image"], batch["code"], batch["cluster_id"]
        # train-mode G forward (torch updates BN running stats on every
        # train forward, including the D step's) — keep the stat update
        with torch.no_grad():
            fake = G(code, train=True, noise=state.generator)
        real_out = D(real, y=code, centroids=centroids, update_sn=True)
        fake_out = D(fake, y=code, centroids=centroids, cls_logits=False)
        metrics = {}
        real_adv, fake_adv = real_out[0], fake_out[0]
        if cfg.ACGAN:
            cls_loss = cluster_ce(real_out[2], ids)
            metrics["d_cls_loss"] = cls_loss
        else:
            cls_loss = 0.0
        adv_loss = hinge_d_loss(real_adv, fake_adv)
        total = cfg.lambda_adv * adv_loss + cfg.lambda_cls * cls_loss
        metrics.update(d_adv_loss=adv_loss, d_total=total,
                       d_real=real_adv.mean(), d_fake=fake_adv.mean())
        self._update(state.opt_d, total)
        return state, pmesh.mean_over(metrics, self.data_group)

    def _update(self, opt: Adam, loss: torch.Tensor) -> None:
        names = list(opt.params)
        grads = torch.autograd.grad(loss, [opt.params[n] for n in names],
                                    allow_unused=True)
        opt.step(pmesh.all_reduce_mean(dict(zip(names, grads)),
                                       self.data_group))

    def chained_gd_step(self, k: int) -> Callable:
        """k (D-step, G-step) pairs on one batch, as the JAX package's
        (there one lax.scan, for measurement; here k eager pairs, whose
        noise draws continue the state's generator). Returns fn(state,
        batch, centroids) -> (state, mean_d_total, mean_g_total)."""

        def many(state, batch, centroids):
            dl, gl = [], []
            for _ in range(k):
                state, dm = self.d_step(state, batch, centroids)
                state, gm = self.g_step(state, batch, centroids)
                dl.append(dm["d_total"])
                gl.append(gm["g_total"])
            return state, torch.stack(dl).mean(), torch.stack(gl).mean()

        return many

    def render(self, state: GanState, code: torch.Tensor) -> torch.Tensor:
        """Inference rendering: codes -> images in [0, 1] (the `denorm`
        of imggen_model.py:44-47), G on its running statistics."""
        return render(state.G, code)
