"""Performance-variant flags, the counterpart of ``repro.flags``.

Each flag is one lever of the multi-pod layout; the dry run's
``--variant`` composes them, so every layout it prices is reproducible:

  base            all off
  remat_saveout   the per-layer activation checkpoint keeps the block's
                  post-collective output, so the recompute does not issue
                  the forward's collectives again
  seqpar          sequence parallelism: the residual stream between blocks
                  is sequence-sharded over 'model'
  dp_only         no tensor parallelism: parameters sharded over
                  (data x model), the batch over every axis
  bf16_params     bfloat16 compute copies of the float32 masters
  serve_tp        serving parameters over 'model' only (no 'data' axis)
  serve_bf16_weights  bfloat16 serving weights (no float32 masters)
  opt             remat_saveout + seqpar

Every flag is off unless a variant sets it, and every flag is read only
while a mesh is armed (``sharding.set_activation_mesh``), except
``bf16_params`` (``models.model._compute_params``) and ``remat_saveout``
(``models.transformer``), which the dry run sets per cell.
"""
from __future__ import annotations

__all__ = ["FLAGS", "VARIANTS", "flag", "set_variant"]

FLAGS = {
    "remat_saveout": False,
    "sequence_parallel": False,
    "dp_only": False,
    "serve_tp": False,
    "bf16_params": False,
    "serve_bf16_weights": False,
}

VARIANTS = {
    "base": {},
    "remat_saveout": {"remat_saveout": True},
    "seqpar": {"sequence_parallel": True},
    "remat_seqpar": {"remat_saveout": True, "sequence_parallel": True},
    "dp_only": {"dp_only": True},
    "dp_only_remat": {"dp_only": True, "remat_saveout": True},
    "serve_tp": {"serve_tp": True},
    "bf16": {"bf16_params": True},
    "bf16_seqpar": {"bf16_params": True, "sequence_parallel": True, "remat_saveout": True},
    "dp_only_bf16": {"dp_only": True, "bf16_params": True},
    "dp_only_bf16_remat": {"dp_only": True, "bf16_params": True, "remat_saveout": True},
    "serve_tp_bf16": {"serve_tp": True, "bf16_params": True},
    "serve_opt": {"serve_tp": True, "serve_bf16_weights": True},
    "opt": {"remat_saveout": True, "sequence_parallel": True},
    # resolved per cell by launch.dryrun.resolve_auto
    "auto": {},
}


def set_variant(name: str):
    for k in FLAGS:
        FLAGS[k] = False
    for k, v in VARIANTS[name].items():
        FLAGS[k] = v


def flag(name: str) -> bool:
    return FLAGS[name]
