"""The integer SNN inference engine (single core) and its chip cost model."""
from .cost import EngineCost, estimate_cost
from .inference import (
    BACKENDS,
    ChunkOutput,
    EngineConfig,
    EngineLayer,
    EngineOutput,
    EngineState,
    SNNEngine,
    build_engine,
    compile_engine,
    init_state,
    reset_slot,
    run_chunk,
    run_engine,
    run_reference,
)
