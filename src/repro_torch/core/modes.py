"""Reconfigurable operating modes + layer mapping (paper C6, Sec II-E, Fig 12).

The SNN core has 9 compute macros (CM) and 3 neuron macros (NU).  A layer's
fan-in (R*S*C for conv, N_in for FC) is mapped across CM *rows* (128 per
macro); output channels/neurons are packed along the 48 columns
(48/W_b per Vmem row pair) and across the 16 Vmem pairs (conv weight
reuse over output positions; FC uses only 1 pair).

  Mode 1  fan-in <= 128*3 : three parallel pipelines of 3 CMs + 1 NU.
          parallel output channels = 3 * 48/W_b            (Eq. 2)
  Mode 2  128*3 < fan-in <= 128*9 : all 9 CMs chained into 1 NU.
          parallel output channels = 48/W_b                (Eq. 2)

Paper cross-checks (Table III footnotes, at 4-bit weights):
  * max input neurons, FC mode 2 : 9 * 128 = 1152
  * max output neurons, conv mode 1: 3 * 12 * 16 = 576

Plain host-side Python, the same code as ``repro.core.modes``, so its
mappings are identical.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

from .cim_macro import CM_WEIGHT_ROWS, IFSPAD_COLS
from .quant import QuantSpec

__all__ = ["CoreConfig", "LayerShape", "LayerMapping", "map_layer"]

N_COMPUTE_MACROS = 9
N_NEURON_MACROS = 3


@dataclasses.dataclass(frozen=True)
class CoreConfig:
    """One SpiDR core.

    ``n_cores`` declares the multi-core extension (paper Sec II-E) — but a
    single ``map_layer`` call only ever maps one core, so ``n_cores > 1``
    is rejected there: multi-core partition/place/schedule is the
    compiler's job (:func:`repro_torch.compiler.compile_network`).
    """

    spec: QuantSpec
    n_compute_macros: int = N_COMPUTE_MACROS
    n_neuron_macros: int = N_NEURON_MACROS
    n_cores: int = 1


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """Shape of one spiking layer in accelerator terms."""

    kind: Literal["conv", "fc"]
    fan_in: int             # R*S*C (conv) or N_in (fc)
    out_channels: int       # K (conv) or N_out (fc)
    out_positions: int = 1  # H_out*W_out for conv; 1 for fc

    @staticmethod
    def conv(r: int, s: int, c: int, k: int, h_out: int, w_out: int) -> "LayerShape":
        return LayerShape("conv", r * s * c, k, h_out * w_out)

    @staticmethod
    def fc(n_in: int, n_out: int) -> "LayerShape":
        return LayerShape("fc", n_in, n_out)


@dataclasses.dataclass(frozen=True)
class LayerMapping:
    mode: int                 # 1 or 2
    pipelines: int            # parallel CM->NU pipelines (3 or 1)
    macros_per_pipeline: int  # CMs chained per pipeline (<= 3 or <= 9)
    rows_per_macro: int       # fan-in rows used per macro (balanced, Sec II-F)
    parallel_channels: int    # output channels computed concurrently (Eq. 2)
    vmem_pairs_used: int      # 16 for conv, 1 for fc
    channel_tiles: int        # sequential tiles over output channels
    position_tiles: int       # sequential tiles over output positions
    fan_in_tiles: int         # sequential tiles when fan-in > mode capacity

    @property
    def total_passes(self) -> int:
        """Weight-stationary passes needed for the full layer."""
        return self.channel_tiles * self.position_tiles * self.fan_in_tiles


def map_layer(shape: LayerShape, core: CoreConfig,
              force_mode: int | None = None) -> LayerMapping:
    """Choose the operating mode and tiling for a layer (Fig 12 logic).

    ``map_layer`` maps a layer onto ONE core.  Multi-core placement is the
    compiler's job (:func:`repro_torch.compiler.compile_network`), which
    calls ``map_layer`` per core on the partitioned slices.

    ``force_mode`` overrides the fan-in-driven mode choice (the compiler's
    selector enumerates both modes when both are feasible); ``None`` keeps
    the paper's Fig 12 rule.
    """
    if core.n_cores > 1:
        raise ValueError(
            f"map_layer maps a layer onto one SpiDR core, but CoreConfig."
            f"n_cores={core.n_cores}; use repro_torch.compiler.compile_network "
            "to partition/place/schedule a network across a multi-core grid "
            "(it invokes map_layer per core on the partitioned slices)"
        )
    spec = core.spec
    ch_per_pair = spec.neurons_per_row  # 48 / W_b

    mode1_cap = CM_WEIGHT_ROWS * 3
    mode2_cap = CM_WEIGHT_ROWS * core.n_compute_macros

    if force_mode is not None and force_mode not in (1, 2):
        raise ValueError(f"mode must be 1 or 2, got {force_mode}")
    mode_choice = force_mode or (1 if shape.fan_in <= mode1_cap else 2)
    if mode_choice == 1:
        mode, pipelines, macros_pp = 1, core.n_neuron_macros, 3
    else:
        mode, pipelines, macros_pp = 2, 1, core.n_compute_macros

    # Balanced row distribution (Sec II-F): input channels spread evenly so
    # spike-density variance, not row count, is the only execution-time skew.
    fan_in_tiles = math.ceil(shape.fan_in / (mode2_cap if mode == 2 else mode1_cap))
    fan_in_per_pass = math.ceil(shape.fan_in / fan_in_tiles)
    rows_per_macro = math.ceil(fan_in_per_pass / macros_pp)

    parallel_channels = pipelines * ch_per_pair  # Eq. (2)

    if shape.kind == "conv":
        vmem_pairs = IFSPAD_COLS
    else:
        vmem_pairs = 1  # no weight reuse: only one even/odd pair active

    channel_tiles = math.ceil(shape.out_channels / parallel_channels)
    position_tiles = math.ceil(shape.out_positions / vmem_pairs)

    return LayerMapping(
        mode=mode,
        pipelines=pipelines,
        macros_per_pipeline=macros_pp,
        rows_per_macro=rows_per_macro,
        parallel_channels=parallel_channels,
        vmem_pairs_used=vmem_pairs,
        channel_tiles=channel_tiles,
        position_tiles=position_tiles,
        fan_in_tiles=fan_in_tiles,
    )


def max_output_neurons_conv_mode1(spec: QuantSpec) -> int:
    """Table III footnote b: 576 at 4-bit."""
    return N_NEURON_MACROS * spec.neurons_per_row * IFSPAD_COLS


def max_input_neurons_fc_mode2() -> int:
    """Table III footnote a: 1152."""
    return N_COMPUTE_MACROS * CM_WEIGHT_ROWS
