"""Pipeline orchestration: profile → approximate → evaluate perplexity →
evaluate the downstream harness tasks (port of ``lqer_tpu/runners.py``).

The config file is the pipeline's state: every stage writes its
artifacts' paths back into the config and saves a
``config_after_<stage>.toml`` with that stage's switch turned off, so a
run resumes from any stage. The artifacts are the JAX package's:
``profile/scale_dict.safetensors``, ``approximate/low_rank_dict.safetensors``
(and ``error_T_dict.safetensors`` with ``keep_error_T``),
``approximate/results.pkl`` and ``results_summary.csv`` (or
``results.json`` without pandas), ``evaluate_perplexity/<dataset>.json``,
``evaluate_harness_downstream/harness_results.json`` (then
``harness_results_{n}.json``) and ``pipeline/config*.toml``.

Every stage runs on an explicit ``device``, ``"cuda"`` by default; a
request for the card without one raises (``device.resolve_device``). The
model's forwards run under ``torch.inference_mode()``. With
``evaluate.pallas_backend`` the evaluation packs every eligible linear for
the kernels (``serving/kernel_backend.py``: kernel 1 and the MLP
megakernel below 512 rows, the unpack kernel and a dense product from 512
rows on); with ``evaluate.fused_attention`` a Llama's attention runs
through the prefill kernel.
"""

from __future__ import annotations

import contextlib
import json
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from . import models
from .device import resolve_device
from .models.checkpoint import (
    load_hf_pretrained,
    load_tensor_dict,
    resolve_model_source,
    save_tensor_dict,
)
from .utils import get_logger, load_config, override_args, save_config
from .utils import wandb_compat

logger = get_logger("runners")

LQER_TPU_ROOT = Path(__file__).resolve().parents[1]

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def _get_dtype(name: str | None, default: str = "float32"):
    return _DTYPES[name or default]


# -- model and data --------------------------------------------------------------
def build_model_config(config: dict):
    """Arch config from ``model_name``, or from a ``[model]`` section
    (``arch`` and the config's fields: tiny offline models)."""
    m = config.get("model")
    if m:
        arch = m.get("arch", "opt")
        kwargs = {k: v for k, v in m.items() if k != "arch"}
        if arch == "opt":
            return models.OPTConfig(**kwargs)
        return models.LlamaConfig(arch=arch, **kwargs)
    return models.get_model_config(config["model_name"])


def build_params(config: dict, cfg, dtype=torch.float32, device="cpu"
                 ) -> dict:
    """Params from the local checkpoint of ``model_name`` (``model_dir``,
    or the local HF hub cache), else random init from a
    ``torch.Generator`` seeded with ``init_seed`` on the CPU (the JAX
    package seeds ``jax.random``: the same shapes, other values); on
    ``device``."""
    src = resolve_model_source(config["model_name"], config.get("model_dir"))
    if src is not None:
        logger.info("Loading pretrained params from %s", src)
        raw = load_hf_pretrained(src)
        return {k: torch.as_tensor(v).to(device, dtype)
                for k, v in raw.items()}
    seed = int(config.get("init_seed", 0))
    logger.warning(
        "No local checkpoint for %s — using random init (seed=%d). "
        "Set `model_dir` in the config to load real weights.",
        config["model_name"], seed)
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = models.init_params(cfg, gen, dtype)
    return {k: v.to(device) for k, v in params.items()}


def _get_tokenizer(config: dict):
    """The model's tokenizer from the local HF cache (never downloaded),
    or None (synthetic data needs none; the harness stage needs one)."""
    name = config.get("tokenizer_name", config["model_name"])
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name, local_files_only=True)
    except Exception as e:
        logger.warning("Tokenizer unavailable (%s); dataset must be "
                       "synthetic", e)
        return None


def _get_split(config_section: dict, config: dict, split: str
               ) -> np.ndarray:
    name = config_section["dataset"]
    tok = None if name == "synthetic" else _get_tokenizer(config)
    extra = {}
    if name == "synthetic":
        extra = dict(config_section.get("synthetic", {}))
        extra.setdefault("vocab_size", 256)
    from .data import get_data_module

    data = get_data_module(
        name, tokenizer=tok, max_length=config_section.get("max_length",
                                                           2048),
        num_raw_samples=config_section.get("num_raw_samples"), **extra)
    return data[split]


# -- stages -------------------------------------------------------------------------
def run_profiler(config: dict, project_path: Path, device="cuda") -> dict:
    """Calibrate the per-channel activation scales on the unquantized
    model; writes ``scale_dict.safetensors``."""
    from .evaluate.perplexity import causal_lm_loss
    from .profiler import ScaleAccumulator, batch_mean_abs_tap

    dev = resolve_device(device)
    profile_config = config["profile"]
    dtype = _get_dtype(profile_config.get("dtype"), "float32")
    cfg = build_model_config(config)
    params = build_params(config, cfg, dtype, dev)
    train = _get_split(profile_config, config, "train")
    batch_size = profile_config.get("batch_size", 4)
    num_samples = profile_config.get("num_samples") or len(train)
    num_batches = max(1, num_samples // batch_size)

    acc = ScaleAccumulator()
    with torch.inference_mode():
        for bi in range(num_batches):
            batch = train[bi * batch_size:(bi + 1) * batch_size]
            if len(batch) == 0:
                break
            ids = torch.as_tensor(batch).to(dev)
            stats: dict = {}
            logits = models.forward(params, ids, cfg, None,
                                    tap=batch_mean_abs_tap(stats))
            acc.update(stats)
            logger.info("Profiling batch %d/%d loss=%.4f", bi + 1,
                        num_batches, float(causal_lm_loss(logits, ids)))
        scale_dict = acc.finalize()
    out = project_path / "scale_dict.safetensors"
    save_tensor_dict(scale_dict, out)
    config["profile"]["scale_dict"] = out.as_posix()
    logger.info("Saved scale_dict (%d entries) to %s", len(scale_dict), out)
    return config


def run_approximator(config: dict, project_path: Path, device="cuda"
                     ) -> dict:
    """The SVD of each weight's (scaled) quantization error, batched per
    group on ``device``; writes ``low_rank_dict.safetensors`` and the
    per-weight error table."""
    from .approximate import get_model_approximator

    dev = resolve_device(device)
    dtype = _get_dtype(config.get("profile", {}).get("dtype"), "float32")
    cfg = build_model_config(config)
    params = build_params(config, cfg, dtype, dev)
    approx_cfg = config["approximate"]
    approximator = get_model_approximator(approx_cfg["name"])(
        params, approx_cfg, device=dev)
    if approximator.requires_scale_dict:
        scale_path = config["profile"]["scale_dict"]
        if not Path(scale_path).exists():
            raise FileNotFoundError(
                f"scale_dict does not exist: {scale_path}, but required by "
                f"{approx_cfg['name']}.")
        approximator.load_scale_dict(load_tensor_dict(scale_path))
    with torch.inference_mode():
        ret = approximator.compute(
            keep_error_T=approx_cfg.get("keep_error_T", True),
            batch_size=approx_cfg.get("batch_size", 8))

    low_rank_path = project_path / "low_rank_dict.safetensors"
    save_tensor_dict(ret["low_rank_dict"], low_rank_path)
    config["evaluate"]["low_rank_dict"] = low_rank_path.as_posix()
    if ret["error_T_dict"]:
        error_T_path = project_path / "error_T_dict.safetensors"
        save_tensor_dict(ret["error_T_dict"], error_T_path)
        config.setdefault("visualize", {})["error_T_dict"] = \
            error_T_path.as_posix()

    rows = ret["df"]
    wandb_compat.log_table("1/n * ||AB - Q_error^T||_1", rows)
    if rows:
        wandb_compat.log_summary(avg_abs_error=sum(
            r["l1_norm(AB-Q_error_T)/n"] for r in rows) / len(rows))
    try:
        import pandas as pd

        df = pd.DataFrame(rows)
        df.to_pickle(project_path / "results.pkl")
        df.describe().to_csv(project_path / "results_summary.csv")
        logger.info("result summary:\n%s", df.describe().to_string())
    except ImportError:
        with open(project_path / "results.json", "w") as f:
            json.dump(rows, f, indent=2)
    return config


def _build_quantized_forward(config: dict, disable_lqer: bool, dtype,
                             device="cuda"):
    """``(cfg, params, layer_qcfgs, backend, fwd)`` of the evaluated model
    on ``device``: the emulated linears on ``prepare_ptq``'s weights with
    the low-rank factors (``backend`` None); or, with
    ``evaluate.pallas_backend``, the kernel backend packed from the
    original weights and factors before the PTQ step (as the JAX package
    packs; ``backend["meta"]`` names the packed entries, the other linears
    run the emulation); ``evaluate.fused_attention`` sends a Llama's
    attention through the prefill kernel. ``fwd(ids)`` returns the
    logits."""
    dev = resolve_device(device)
    cfg = build_model_config(config)
    params = build_params(config, cfg, dtype, dev)
    qcfgs = models.quantize_model(cfg, config.get("q_config"),
                                  config.get("l_config"))
    evaluate = config.get("evaluate", {})
    backend = None

    def with_low_rank(params):
        ab = load_tensor_dict(evaluate["low_rank_dict"])
        logger.info("🔉 Evaluating LQER model")
        return models.load_low_rank_dict(
            params, {k: torch.as_tensor(v).to(dev) for k, v in ab.items()},
            dtype=dtype)

    if evaluate.get("pallas_backend", False) and qcfgs is not None:
        from .serving.kernel_backend import prepare_serving_params

        if not disable_lqer:
            params = with_low_rank(params)
        backend = prepare_serving_params(params, cfg, qcfgs)
        params = models.prepare_ptq(params, cfg, qcfgs)
        logger.info("evaluating through the serving kernels")
    else:
        params = models.prepare_ptq(params, cfg, qcfgs)
        if qcfgs is not None and not disable_lqer:
            params = with_low_rank(params)
        elif qcfgs is not None:
            logger.info("🔉 LQER disabled. Evaluating WxAy without Ak Bk")

    arch_fwd = models.get_arch_module(cfg).forward
    kwargs = {}
    if cfg.arch in ("llama", "mistral") and evaluate.get("fused_attention",
                                                         False):
        logger.info("using the fused prefill attention")
        kwargs["fused_attention"] = True

    def fwd(ids):
        return arch_fwd(params, ids, cfg, qcfgs, backend=backend, **kwargs)

    return cfg, params, qcfgs, backend, fwd


def run_evaluate_perplexity(config: dict, project_path: Path,
                            device="cuda") -> dict:
    """Perplexity of the quantized (LQER-corrected, unless
    ``evaluate.disable_lqer``) model on the test split; writes
    ``<dataset>.json``."""
    from .evaluate import evaluate_perplexity

    dev = resolve_device(device)
    eval_config = config["evaluate"]
    eval_ppl_config = eval_config["perplexity"]
    dtype = _get_dtype(eval_config.get("dtype"), "float32")
    *_, fwd = _build_quantized_forward(
        config, eval_config.get("disable_lqer", False), dtype, dev)
    test = _get_split(eval_ppl_config, config, "test")
    with torch.inference_mode():
        results = evaluate_perplexity(
            fwd, test, batch_size=eval_ppl_config.get("batch_size", 4),
            num_samples=eval_ppl_config.get("num_samples"),
            progress=eval_ppl_config.get("progress_bar", True),
            description=("Evaluating perplexity on "
                         f"{eval_ppl_config['dataset']}..."),
            device=dev)
    logger.info("results:\n%s", json.dumps(results, indent=4))
    save_file = project_path / (
        eval_ppl_config["dataset"].replace("/", "_") + ".json")
    with open(save_file, "w") as f:
        json.dump(results, f, indent=4)
    wandb_compat.log_table(
        f"{eval_ppl_config['dataset']}_results",
        [{"entry": k, "value": v} for k, v in results.items()])
    wandb_compat.log_summary(
        **{f"{eval_ppl_config['dataset']}_ppl": results["perplexity"]})
    return config


def run_evaluate_harness_downstream(config: dict, project_path: Path,
                                    device="cuda") -> dict:
    """The downstream 0-shot tasks through lm_eval, or without it through
    the bundled :mod:`.evaluate.minieval`, whose ``tiny_*`` tasks run and
    whose unknown task names are skipped with a warning (the stage too when
    no task is left), as in the JAX package. Loglikelihood requests run the
    evaluated model's forward (``_build_quantized_forward``); generation
    decodes through a one-slot ``DecodeEngine`` over the same params,
    without a kernel backend, built on the first generation request.
    Writes ``harness_results.json`` (``harness_results_{n}.json`` beside
    an earlier one)."""
    from .evaluate.harness import HAS_LM_EVAL, evaluate_harness_downstream

    dev = resolve_device(device)
    eval_config = config["evaluate"]
    eval_hd_config = eval_config["harness_downstream"]
    dtype = _get_dtype(eval_config.get("dtype"), "float32")
    tasks = list(eval_hd_config["datasets"])
    if not HAS_LM_EVAL:
        from .evaluate.minieval import TASK_REGISTRY

        known = [t for t in tasks if t in TASK_REGISTRY]
        if len(known) != len(tasks):
            logger.warning(
                "lm_eval not installed: skipping real benchmark tasks %s "
                "(minieval runs bundled tiny_* fixtures only)",
                [t for t in tasks if t not in TASK_REGISTRY])
        tasks = known
        if not tasks:
            logger.warning("no runnable harness tasks; skipping stage")
            return config

    cfg, params, qcfgs, _, fwd = _build_quantized_forward(
        config, eval_config.get("disable_lqer", False), dtype, dev)
    tokenizer = _get_tokenizer(config)
    max_length = eval_hd_config.get("max_length", 2048)
    from .serving import DecodeEngine

    def engine():
        return DecodeEngine(params, cfg, qcfgs, num_slots=1,
                            max_len=max_length, cache_dtype=dtype,
                            device=dev)

    results = evaluate_harness_downstream(
        fwd, tokenizer, tasks=tasks,
        num_fewshot=eval_hd_config.get("num_fewshot", 0),
        batch_size=eval_hd_config.get("batch_size", None),
        max_length=max_length, engine=engine, device=dev)
    save_path = project_path / "harness_results.json"
    if save_path.exists():
        n = len(list(project_path.glob("harness_results_*.json")))
        save_path = project_path / f"harness_results_{n}.json"
    with open(save_path, "w") as f:
        json.dump(results, f, indent=4, default=str)
    logger.info("results saved to %s", save_path)
    return config


# -- the pipeline -------------------------------------------------------------------
def get_project_path(config: dict, tags: list[str], action: str) -> Path:
    """``checkpoints/<project>/<tags>/<action>`` under the repository
    root, or ``<checkpoint_path>/<action>``; a non-empty directory raises
    ``RuntimeError`` unless ``overwrite_checkpoint``."""
    if "checkpoint_path" not in config:
        tag = "_".join(tags).replace("/", "-")
        project_path = (LQER_TPU_ROOT / "checkpoints"
                        / config["project"].replace("/", "-") / tag / action)
    else:
        project_path = Path(config["checkpoint_path"]).resolve() / action
    if project_path.exists() and any(project_path.iterdir()):
        if not config.get("overwrite_checkpoint", False):
            raise RuntimeError(
                f"Project path {project_path} exists but is not empty.")
        logger.warning("Project path %s not empty. Overwriting...",
                       project_path)
    project_path.mkdir(parents=True, exist_ok=True)
    return project_path


def parse_args(action: str, argv=None, device: str = "cuda"):
    """``<config.toml> [tags…] [--device D] [--a:b:c=v …]`` →
    ``(config, project_path, device)``. ``--device`` (``device`` when
    absent) is taken out before the overrides and resolved before the
    project directory is made."""
    parser = ArgumentParser(prog=f"lqer_tpu_torch.cli {action}")
    parser.add_argument("config", type=str)
    parser.add_argument("tags", type=str, nargs="*")
    parser.add_argument("--device", type=str, default=device)
    args, unknown = parser.parse_known_args(argv)
    dev = resolve_device(args.device)
    config = load_config(args.config)
    config, overridden = override_args(config, unknown)
    if overridden:
        logger.info("overridden args: %s", overridden)
    tags = args.tags + config.get("tags", [])
    return config, get_project_path(config, tags=tags, action=action), dev


def run_pipeline(argv=None, device: str = "cuda", stage_hook=None) -> dict:
    """Profile → approximate → evaluate perplexity → the harness tasks,
    each stage where its ``enable_*`` switch is on; ``argv`` as
    :func:`parse_args` takes it. ``stage_hook(folder)``, where given,
    returns a context manager that wraps each stage run (``folder``:
    ``profile``, ``approximate``, ``evaluate_perplexity`` or
    ``evaluate_harness_downstream``), for example to time it."""
    config, prj, dev = parse_args("pipeline", argv, device)
    wandb_compat.maybe_init(config, "pipeline")
    stages = (
        ("enable_profiling", "profile", run_profiler, "profiling",
         "Profiling"),
        ("enable_approximation", "approximate", run_approximator,
         "approximation", "Approximating"),
        ("enable_perplexity_evaluation", "evaluate_perplexity",
         run_evaluate_perplexity, "perplexity_evaluation",
         "Evaluating perplexity"),
        ("enable_harness_downstream_evaluation",
         "evaluate_harness_downstream", run_evaluate_harness_downstream,
         "harness_downstream_evaluation", "Evaluating harness downstream"),
    )
    for switch, folder, stage, after, what in stages:
        if not config.get(switch, False):
            continue
        logger.info("🚀 %s...", what)
        stage_dir = prj.parent / folder
        stage_dir.mkdir(parents=True, exist_ok=True)
        with stage_hook(folder) if stage_hook else contextlib.nullcontext():
            config = stage(config, stage_dir, dev)
        config[switch] = False
        save_config(config, prj / f"config_after_{after}.toml")
    save_config(config, prj / "config.toml")
    wandb_compat.finish()
    logger.info("✅ Done.")
    return config
