"""Fused-kernel mode resolution (counterpart of tvts_tpu/ops/kernel_config.py):
the same `trainer.kernels` keys, the same per-arch presets and the same
resolution order (highest wins):
    1. TVTS_* environment variables
    2. explicit keys in the config's ``trainer.kernels`` section
    3. the per-arch preset table (``preset``: "default" or "best")

`resolve_kernel_config` returns the JAX package's dict unchanged, so one
config file drives both. `train_apply_kwargs` maps it onto the port:
- every space mode (pallas, pallas_ps, pallas_v2, pallas_v5, pallas_v10,
  pallas_v10r) computes the same function and runs H5; every time mode
  (pallas, pallas_tps, pallas_v3) runs H6; "xla" runs the plain sub-path;
- text_mode / sort_mode "pallas" run H7, "xla" the plain torch modules;
- mlp_mode "pallas" (which no preset sets) runs H8 in its recomputing form,
  "xla" the plain torch MLP;
- layout "dmajor" is the JAX package's all-kernel tower (its space, time and
  mlp modes are ignored there): H5, H6 and H8 in its hidden-saving form;
- the other knobs that only schedule the TPU kernels (sfpp, time_chunk,
  time_vmem_mb, scan, smv, interpret; save_acts, which picks saved or
  recomputed activations) are accepted and logged as ignored;
- text_tune_from (the first trainable text block) comes from the
  OptimizerConfig, not from a separate argument.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

# (kwarg, config key, env var, parse), as in the JAX package
_KEYS = (
    ("space_mode", "space_mode", "TVTS_SPACE_MODE", str),
    ("time_mode", "time_mode", "TVTS_TIME_MODE", str),
    ("mlp_mode", "mlp_mode", "TVTS_MLP_MODE", str),
    ("layout", "layout", "TVTS_LAYOUT", str),
    ("space_fpp", "sfpp", "TVTS_SFPP", lambda s: int(s) or None),
    ("time_chunk", "time_chunk", "TVTS_TIME_CHUNK", int),
    ("save_acts", "save_acts", "TVTS_SAVE_ACTS", lambda s: s == "1"),
    ("scan_blocks", "scan", "TVTS_SCAN", lambda s: s == "1"),
    ("time_vmem_mb", "time_vmem_mb", "TVTS_TIME_VMEM_MB", int),
    ("smv", "smv", "TVTS_V9_SMV", str),
    ("text_mode", "text_mode", "TVTS_TEXT_MODE", str),
    ("sort_mode", "sort_mode", "TVTS_SORT_MODE", str),
    ("interpret", "interpret", "TVTS_INTERPRET", lambda s: s == "1"),
)

_BASE = dict(space_mode="pallas_v10r", time_mode="pallas", mlp_mode="xla",
             layout="row", space_fpp=None, time_chunk=128, save_acts=True,
             scan_blocks=False, time_vmem_mb=100, smv=None,
             text_mode="xla", sort_mode="xla", interpret=False)

KERNEL_DEFAULTS = {
    "TVTSv2_B_16": dict(_BASE),
    "TVTSv2_B_32": dict(_BASE, space_mode="pallas_v2", time_chunk=64),
    "TVTSv2_H_14": dict(_BASE, space_mode="pallas", time_mode="xla", save_acts=False),
}

KERNEL_BEST = {
    "TVTSv2_B_16": dict(_BASE, space_mode="pallas_v10", space_fpp=4,
                        time_mode="pallas_tps", text_mode="pallas", sort_mode="pallas"),
    "TVTSv2_B_32": dict(_BASE, space_mode="pallas_v2", time_chunk=64),
    "TVTSv2_H_14": dict(_BASE, space_mode="pallas", time_mode="xla", save_acts=False,
                        text_mode="pallas"),
}

SPACE_MODES = ("pallas", "pallas_ps", "pallas_v2", "pallas_v5", "pallas_v10", "pallas_v10r")
TIME_MODES = ("pallas", "pallas_tps", "pallas_v3")
TPU_SCHEDULE_KNOBS = ("space_fpp", "time_chunk", "time_vmem_mb", "scan_blocks",
                      "smv", "interpret", "save_acts")


def resolve_kernel_config(arch: str, kernels_cfg: dict | None = None,
                          env: dict | None = None) -> dict:
    """The fused-kernel kwargs for ``arch`` (the JAX package's keys and values)."""
    env = os.environ if env is None else env
    kernels_cfg = kernels_cfg or {}
    preset = kernels_cfg.get("preset", "default")
    if preset not in ("default", "best"):
        raise ValueError(f"trainer.kernels.preset must be 'default' or 'best', got {preset!r}")
    table = KERNEL_BEST if preset == "best" else KERNEL_DEFAULTS
    out = dict(table.get(arch, _BASE))
    for kwarg, cfg_key, env_var, parse in _KEYS:
        if cfg_key in kernels_cfg:
            val = kernels_cfg[cfg_key]
            out[kwarg] = parse(str(val)) if isinstance(val, str) else val
            if kwarg == "space_fpp" and val in (0, "0"):
                out[kwarg] = None
        if env_var in env:
            out[kwarg] = parse(env[env_var])
    return out


def _kernel_or_plain(name: str, mode: str, kernel_modes: tuple) -> bool:
    if mode == "xla":
        return False
    if mode not in kernel_modes:
        raise ValueError(f"{name} {mode!r} not in {kernel_modes + ('xla',)}")
    return True


def train_apply_kwargs(kcfg: dict, opt_cfg=None) -> dict:
    """ops/fused_forward.train_apply's keyword arguments for a resolved
    config; text_tune_from from `opt_cfg` (an OptimizerConfig) when the text
    tower runs H7."""
    layout = kcfg.get("layout", "row")
    if layout not in ("row", "dmajor"):
        raise ValueError(f"layout {layout!r} not in ('row', 'dmajor')")
    dmajor = layout == "dmajor"
    ignored = {k: kcfg[k] for k in TPU_SCHEDULE_KNOBS if k in kcfg and kcfg[k] != _BASE[k]}
    if ignored:
        log.info("ignoring TPU schedule knobs %s: the Hopper kernels choose their own "
                 "schedule", ignored)
    text_kernel = _kernel_or_plain("text_mode", kcfg["text_mode"], ("pallas",))
    kernels = (_kernel_or_plain("space_mode", kcfg["space_mode"], SPACE_MODES),
               _kernel_or_plain("time_mode", kcfg["time_mode"], TIME_MODES),
               _kernel_or_plain("mlp_mode", kcfg["mlp_mode"], ("pallas",)))
    space_kernel, time_kernel, mlp_kernel = (True, True, True) if dmajor else kernels
    return dict(space_kernel=space_kernel, time_kernel=time_kernel, mlp_kernel=mlp_kernel,
                mlp_save_hidden=dmajor, text_kernel=text_kernel,
                sort_kernel=_kernel_or_plain("sort_mode", kcfg["sort_mode"], ("pallas",)),
                text_tune_from=opt_cfg.text_tune_from if text_kernel and opt_cfg else None)
