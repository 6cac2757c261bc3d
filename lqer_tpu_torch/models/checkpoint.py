"""Checkpoint and artifact IO (port of ``lqer_tpu/models/checkpoint.py``).

* HF pretrained checkpoints in a local directory (safetensors, sharded or
  not, or torch ``.bin`` shards) → a flat ``{hf_name: np.ndarray}`` dict,
  half precision upcast to f32.
* Pipeline artifacts (``low_rank_dict`` and the like): ``.safetensors``
  or ``.npz``; loading also takes the reference's torch ``.pt`` files and
  a list of chunk paths.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..utils.logging import get_logger

logger = get_logger("checkpoint")


def load_tensor_dict(path) -> dict[str, np.ndarray]:
    """One artifact file, or the merge of a list of chunk paths."""
    if isinstance(path, (list, tuple)):
        merged: dict[str, np.ndarray] = {}
        for p in path:
            merged.update(load_tensor_dict(p))
        return merged
    path = Path(path)
    if path.suffix == ".safetensors":
        from safetensors.numpy import load_file

        return load_file(str(path))
    if path.suffix in (".pt", ".bin", ".pth"):
        import torch

        obj = torch.load(str(path), map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in obj.items()}
    if path.suffix == ".npz":
        with np.load(str(path)) as z:
            return {k: z[k] for k in z.files}
    raise ValueError(f"Unknown artifact format: {path}")


def save_tensor_dict(d: dict, path) -> None:
    """``.safetensors`` or ``.npz``; tensors are saved as their numpy
    arrays."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                  else np.asarray(v)) for k, v in d.items()}
    if path.suffix == ".safetensors":
        from safetensors.numpy import save_file

        save_file(arrays, str(path))
    elif path.suffix == ".npz":
        np.savez(str(path), **arrays)
    else:
        raise ValueError(f"Unknown artifact format: {path}")


def load_hf_pretrained(model_dir) -> dict[str, np.ndarray]:
    """A local HF checkpoint directory → a flat param dict: single or
    sharded safetensors (``model.safetensors.index.json``), else torch
    ``pytorch_model*.bin``; fp16 and bf16 upcast to f32."""
    model_dir = Path(model_dir)
    params: dict[str, np.ndarray] = {}
    st_files = sorted(model_dir.glob("*.safetensors"))
    index = model_dir / "model.safetensors.index.json"
    if index.exists():
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        st_files = sorted({model_dir / v for v in weight_map.values()})
    if st_files:
        import torch
        from safetensors.torch import load_file

        for fp in st_files:
            for k, t in load_file(str(fp)).items():
                params[k] = (t.float() if t.dtype in (torch.float16,
                                                      torch.bfloat16)
                             else t).numpy()
        return params
    bin_files = sorted(model_dir.glob("pytorch_model*.bin"))
    if bin_files:
        import torch

        for fp in bin_files:
            obj = torch.load(str(fp), map_location="cpu", weights_only=True)
            for k, v in obj.items():
                params[k] = v.float().numpy()
        return params
    raise FileNotFoundError(f"No checkpoint files found under {model_dir}")


def resolve_model_source(model_name: str, local_dir: str | None = None):
    """A local checkpoint directory for ``model_name``: ``local_dir``, else
    a snapshot of the model in the local HF hub cache; None when neither
    exists (random init, the offline test mode). Nothing is downloaded."""
    candidates = []
    if local_dir:
        candidates.append(Path(local_dir))
    cache = Path.home() / ".cache/huggingface/hub"
    hub_name = "models--" + model_name.replace("/", "--")
    if (cache / hub_name).exists():
        candidates.extend(sorted((cache / hub_name / "snapshots").glob("*")))
    for c in candidates:
        if c.is_dir():
            return c
    return None
