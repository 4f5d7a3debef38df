"""The integer SNN inference engine (single- and multi-core plans), its
chip cost models and the persistent-Vmem streaming sessions."""
from .cost import EngineCost, MulticoreCost, estimate_cost, estimate_multicore_cost
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
from .streaming import SESSION_SCHEMA_VERSION, SlotUpdate, StreamSessionManager
