"""Optional wandb logging (port of ``lqer_tpu/utils/wandb_compat.py``):
per-stage tables and run summaries when ``wandb`` is installed and the
config sets ``enable_wandb``; without ``wandb`` every call does nothing
(``maybe_init`` logs a warning), so such configs still run."""

from __future__ import annotations

from .logging import get_logger

logger = get_logger("wandb")

try:
    import wandb

    HAS_WANDB = True
except ImportError:
    wandb = None
    HAS_WANDB = False

_run = None


def maybe_init(config: dict, job_type: str = "pipeline"):
    """``wandb.init`` from the config's ``[wandb]`` section."""
    global _run
    if not config.get("enable_wandb"):
        return None
    if not HAS_WANDB:
        logger.warning("enable_wandb=true but wandb is not installed; "
                       "skipping")
        return None
    wandb_cfg = config.get("wandb", {})
    tags = list(set(wandb_cfg.get("tags", []) + [job_type]
                    + config.get("tags", [])))
    _run = wandb.init(project=wandb_cfg.get("project"),
                      entity=wandb_cfg.get("entity"),
                      job_type=wandb_cfg.get("job_type", job_type),
                      tags=tags)
    return _run


def log_table(name: str, rows: list[dict]) -> None:
    if _run is None or not rows:
        return
    cols = list(rows[0].keys())
    wandb.log({name: wandb.Table(
        columns=cols, data=[[r.get(c) for c in cols] for r in rows])})


def log_summary(**kv) -> None:
    if _run is None:
        return
    for k, v in kv.items():
        _run.summary[k] = v


def finish() -> None:
    global _run
    if _run is not None:
        wandb.finish()
    _run = None
