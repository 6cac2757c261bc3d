"""Chunked approximation (port of ``lqer_tpu/chunked_runners.py``): the
offline SVD stage split over independent CLI invocations, each on its own
``--device``.

``run_approximator_chunk`` keeps the slice
``[chunk_idx·chunk_size : (chunk_idx+1)·chunk_size]`` of the approximator's
ordered weight list and writes that chunk's artifacts:
``low_rank_dict/chunk_XX_of_YY.safetensors``, ``results_chunk_XX_of_YY.json``
and ``config_chunk_XX_of_YY.toml``. ``merge_chunks`` gathers a directory's
chunk configs into ``config_merged.toml``, whose ``evaluate.low_rank_dict``
is the list of chunk paths (``models.checkpoint.load_tensor_dict`` merges
such a list), and ``results_merged.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from .approximate import get_model_approximator
from .device import resolve_device
from .models.checkpoint import load_tensor_dict, save_tensor_dict
from .runners import (
    _get_dtype,
    build_model_config,
    build_params,
    parse_args,
)
from .utils import get_logger, load_config, save_config

logger = get_logger("chunked_runners")


def run_approximator_chunk(config: dict, project_path: Path, device="cuda"
                           ) -> dict:
    """One chunk of ``approximate.chunk_size`` weights, chunk
    ``approximate.chunk_idx``; returns the chunk's config."""
    dev = resolve_device(device)
    project_path = Path(project_path)
    approx_cfg = config["approximate"]
    chunk_size = approx_cfg["chunk_size"]
    chunk_idx = approx_cfg["chunk_idx"]

    dtype = _get_dtype(config.get("profile", {}).get("dtype"), "float32")
    cfg = build_model_config(config)
    params = build_params(config, cfg, dtype, dev)
    approximator = get_model_approximator(approx_cfg["name"])(
        params, approx_cfg, device=dev)
    names = list(approximator.entries)
    num_chunks = -(-len(names) // chunk_size)
    assert chunk_idx < num_chunks, (chunk_idx, num_chunks)
    keep = set(names[chunk_idx * chunk_size:(chunk_idx + 1) * chunk_size])
    approximator.entries = {k: v for k, v in approximator.entries.items()
                            if k in keep}
    if approximator.requires_scale_dict:
        approximator.load_scale_dict(
            load_tensor_dict(config["profile"]["scale_dict"]))
    with torch.inference_mode():
        ret = approximator.compute(
            keep_error_T=approx_cfg.get("keep_error_T", False),
            batch_size=approx_cfg.get("batch_size", 8))

    tag = f"chunk_{chunk_idx:02d}_of_{num_chunks:02d}"
    low_rank_path = project_path / "low_rank_dict" / f"{tag}.safetensors"
    save_tensor_dict(ret["low_rank_dict"], low_rank_path)
    with open(project_path / f"results_{tag}.json", "w") as f:
        json.dump(ret["df"], f, indent=2)

    chunk_cfg = dict(config)
    chunk_cfg["evaluate"] = dict(config.get("evaluate", {}))
    chunk_cfg["evaluate"]["low_rank_dict"] = low_rank_path.as_posix()
    chunk_cfg["approximate"] = dict(approx_cfg, num_chunks=num_chunks)
    save_config(chunk_cfg, project_path / f"config_{tag}.toml")
    logger.info("chunk %d/%d: %d weights -> %s", chunk_idx + 1, num_chunks,
                len(keep), low_rank_path)
    return chunk_cfg


def merge_chunks(project_path: Path) -> dict:
    """Merge the chunk configs under ``project_path`` (all of them must be
    there) into ``config_merged.toml``; returns the merged config."""
    project_path = Path(project_path)
    chunk_configs = sorted(project_path.glob("config_chunk_*_of_*.toml"))
    assert chunk_configs, f"no chunk configs under {project_path}"

    merged = None
    paths = []
    rows = []
    for cc in chunk_configs:
        cfg = load_config(cc)
        num_chunks = cfg["approximate"]["num_chunks"]
        paths.append(cfg["evaluate"]["low_rank_dict"])
        tag = cc.stem.removeprefix("config_")
        res = project_path / f"results_{tag}.json"
        if res.exists():
            with open(res) as f:
                rows.extend(json.load(f))
        if merged is None:
            merged = cfg
    assert len(chunk_configs) == num_chunks, (
        f"expected {num_chunks} chunks, found {len(chunk_configs)}")
    merged["evaluate"]["low_rank_dict"] = paths  # list form; loader merges
    with open(project_path / "results_merged.json", "w") as f:
        json.dump(rows, f, indent=2)
    save_config(merged, project_path / "config_merged.toml")
    logger.info("merged %d chunks", len(paths))
    return merged


def run_chunked_approximator(argv=None, device: str = "cuda") -> dict:
    """``<config.toml> [tags…] [--device D] [--a:b:c=v …]`` → one chunk,
    into ``<project>/approximate_chunked``."""
    config, prj, dev = parse_args("approximate_chunked", argv, device)
    return run_approximator_chunk(config, prj, dev)
