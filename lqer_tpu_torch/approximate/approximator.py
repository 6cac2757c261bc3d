"""LQER-SVD and L²QER approximators over flat param dicts (port of
``lqer_tpu/approximate/approximator.py``).

* ``q_error_T = (W − W_q(W))^T``;
* lqer-svd: ``U, S, V^T = svd(E^T)``, ``A = A_q(U_k)``,
  ``B = B_q(diag(S_k) V^T_k)``;
* lqer-act: ``U, S, V^T = svd(diag(s) E^T)``,
  ``A = A_q(diag(s)^-1 U_k)``, ``B = B_q(diag(S_k) V^T_k)``, with ``s``
  the calibrated per-input-channel scale;
* the quality metric ``l1_norm(A B − target) / numel``, with the target
  the (scaled, for lqer-act) error.

Weights that share a shape, quantizer configs and rank form a group; each
group goes through the steps above stacked, ``batch_size`` weights at a
time, in f32 on the device, with one batched ``torch.linalg.svd`` (the
JAX package ``vmap``s the same steps). A and B are fixed only up to the
sign of each singular pair, so two SVDs agree on ``A B``, not on A and B.

On the card the SVD runs cuSOLVER's ``gesvda``. At Llama-2-7B's shapes
the top singular values of a quantization error lie close together
(sigma_32 and sigma_33 0.03–0.1% apart), and there the default driver
(``gesvdj``) puts the rank-32 product 1.2–2.5% off an f64 SVD and
``gesvd`` up to 1.1%, where ``gesvda`` stays within 2e-7, at a seventh
of the time (``tools/svd_drivers.py``).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quantizers import make_quantizer
from ..utils.config import find_matched_pattern
from ..utils.logging import get_logger

logger = get_logger("approximate")


def _each(quantizer: Callable, x: torch.Tensor) -> torch.Tensor:
    """``quantizer`` on each 2-D matrix of ``x`` apart: a block shape of
    two dims would otherwise read the stacking axis as one block."""
    if x.ndim == 2:
        return quantizer(x)
    return torch.stack([quantizer(m) for m in x.reshape(-1, *x.shape[-2:])]
                       ).reshape(x.shape)


def approximate_weight(w: torch.Tensor, rank: int, w_quantizer: Callable,
                       a_quantizer: Callable, b_quantizer: Callable,
                       scale: torch.Tensor | None = None):
    """``(A, B, q_error_T)`` for a weight ``(..., out, in)`` (leading axes
    batch the weights); ``scale (..., in)`` is lqer-act's per-channel
    activation scale, None for lqer-svd."""
    wf = w.to(torch.float32)
    e_t = (wf - _each(w_quantizer, wf)).transpose(-1, -2)  # (..., in, out)
    target = e_t if scale is None else scale[..., :, None] * e_t
    kw = {"driver": "gesvda"} if target.is_cuda else {}
    u, s, vt = torch.linalg.svd(target, full_matrices=False, **kw)
    u_k = u[..., :rank]
    b = s[..., :rank, None] * vt[..., :rank, :]
    a = u_k if scale is None else u_k / scale[..., :, None]
    return _each(a_quantizer, a), _each(b_quantizer, b), target


def _l1_metric(a, b, target):
    """``l1_norm(A B − target) / numel`` over the last two axes."""
    return ((torch.matmul(a, b) - target).abs().sum((-2, -1))
            / (target.shape[-2] * target.shape[-1]))


class _Group:
    """Weights sharing (shape, quantizer configs, rank): approximated
    stacked."""

    def __init__(self, rank, w_q_cfg, a_q_cfg, b_q_cfg):
        self.rank = rank
        self.w_q_cfg = w_q_cfg
        self.a_q_cfg = a_q_cfg
        self.b_q_cfg = b_q_cfg
        self.names: list[str] = []
        self.weights: list = []
        self.scales: list = []


class ModelApproximator:
    """The model-level driver, configured as the reference's
    ``[approximate]`` section: ``{"name": "lqer-svd" | "lqer-act",
    "approximator": {regex: cfg | "default", "default": {rank,
    W_quantizer, A_quantizer, B_quantizer}}}``. Each weight whose name one
    regex fullmatches is approximated with that entry's settings (a string
    names another entry). The work runs on ``device``, ``"cuda"`` by
    default (``device.resolve_device``: without a card it raises)."""

    def __init__(self, state_dict: dict, config: dict,
                 name: str | None = None, device="cuda"):
        self.config = config
        self.name = name or config.get("name", "lqer-svd")
        if self.name not in ("lqer-svd", "lqer-act"):
            raise ValueError(f"model approximator {self.name!r} not "
                             "supported")
        self.requires_scale_dict = self.name == "lqer-act"
        self.device = resolve_device(device)
        self.entries: dict[str, dict] = {}
        self.scale_dict: dict[str, torch.Tensor] | None = None

        approx_cfgs = config["approximator"]
        patterns = list(approx_cfgs.keys())
        for w_name, w in state_dict.items():
            entry = find_matched_pattern(w_name, patterns)
            if entry is None:
                continue
            cfg = approx_cfgs[entry]
            if isinstance(cfg, str):
                cfg = approx_cfgs[cfg]
            if not isinstance(cfg, dict):
                raise TypeError(f"approximator entry {entry!r} is not a "
                                "table")
            self.entries[w_name] = {"weight": w, "cfg": cfg}
        if not self.entries:
            logger.error("No matched weight found. Check the config file "
                         "and weight names.")

    def __len__(self):
        return len(self.entries)

    def load_scale_dict(self, scale_dict: dict) -> None:
        """Attach the profiler's scales, keyed ``<module>.scale``."""
        self.scale_dict = {}
        for w_name, e in self.entries.items():
            scale_name = ".".join(w_name.split(".")[:-1] + ["scale"])
            s = torch.as_tensor(scale_dict[scale_name])
            in_features = e["weight"].shape[1]
            if tuple(s.shape) != (in_features,):
                raise ValueError(f"{scale_name}: shape {tuple(s.shape)}, "
                                 f"expected ({in_features},)")
            self.scale_dict[w_name] = s

    def _build_groups(self) -> list[_Group]:
        groups: dict[tuple, _Group] = {}
        for w_name, e in self.entries.items():
            cfg, w = e["cfg"], e["weight"]
            key = (tuple(w.shape),
                   repr(sorted(cfg["W_quantizer"].items())),
                   repr(sorted(cfg["A_quantizer"].items())),
                   repr(sorted(cfg["B_quantizer"].items())),
                   cfg["rank"])
            if key not in groups:
                groups[key] = _Group(cfg["rank"], cfg["W_quantizer"],
                                     cfg["A_quantizer"], cfg["B_quantizer"])
            g = groups[key]
            g.names.append(w_name)
            g.weights.append(w)
            if self.scale_dict is not None:
                g.scales.append(self.scale_dict[w_name])
        return list(groups.values())

    def compute(self, keep_error_T: bool = True, batch_size: int = 8
                ) -> dict:
        """Approximate every matched weight: ``{"df": rows,
        "low_rank_dict": {<module>.A, <module>.B}, "error_T_dict"}``, the
        arrays as f32 numpy."""
        if self.requires_scale_dict and self.scale_dict is None:
            raise RuntimeError("lqer-act requires load_scale_dict() first")
        rows = []
        low_rank_dict: dict[str, np.ndarray] = {}
        error_T_dict: dict[str, np.ndarray] = {}

        def stack(ts):
            return torch.stack([torch.as_tensor(t).to(
                self.device, torch.float32) for t in ts])

        for g in self._build_groups():
            w_q = make_quantizer(g.w_q_cfg)
            a_q = make_quantizer(g.a_q_cfg)
            b_q = make_quantizer(g.b_q_cfg)
            n = len(g.names)
            for start in range(0, n, batch_size):
                stop = min(start + batch_size, n)
                ws = stack(g.weights[start:stop])
                ss = stack(g.scales[start:stop]) if g.scales else None
                a, b, target = approximate_weight(ws, g.rank, w_q, a_q, b_q,
                                                  scale=ss)
                metric = _l1_metric(a, b, target).cpu().numpy()
                a, b = a.cpu().numpy(), b.cpu().numpy()
                if keep_error_T:
                    target = target.cpu().numpy()
                for j, w_name in enumerate(g.names[start:stop]):
                    module = ".".join(w_name.split(".")[:-1])
                    low_rank_dict[module + ".A"] = a[j]
                    low_rank_dict[module + ".B"] = b[j]
                    if keep_error_T:
                        error_T_dict[w_name] = target[j]
                    rows.append({"name": w_name, "rank": g.rank,
                                 "l1_norm(AB-Q_error_T)/n": float(metric[j]),
                                 "w_dim0": int(ws.shape[1]),
                                 "w_dim1": int(ws.shape[2])})
                    logger.info("%-60s 1/n * ||AB - Q_error^T||_1 = %.6f",
                                w_name, float(metric[j]))
        return {"df": rows, "low_rank_dict": low_rank_dict,
                "error_T_dict": error_T_dict}


def get_model_approximator(name: str):
    """Name → constructor ``(state_dict, config, device=)``."""
    if name in ("lqer-svd", "lqer-act"):
        return functools.partial(ModelApproximator, name=name)
    raise ValueError(f"model approximator {name!r} not supported")
