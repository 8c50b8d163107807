from repro_torch.serve.engine import (
    FINISH_REASONS,
    NonFiniteLogitsError,
    Request,
    ServeEngine,
    stream_match_rate,
)
from repro_torch.serve.faults import (
    ChaosInjector,
    current_fault_injector,
    fault_point,
    install_fault_injector,
)
from repro_torch.serve.paged import BlockPool, blocks_for, kv_token_bytes
from repro_torch.serve.sampling import sample_token, sample_tokens
from repro_torch.serve.snapshot import restore_engine, save_snapshot

__all__ = ["BlockPool", "ChaosInjector", "FINISH_REASONS",
           "NonFiniteLogitsError", "Request", "ServeEngine", "blocks_for",
           "current_fault_injector", "fault_point", "install_fault_injector",
           "kv_token_bytes", "restore_engine", "sample_token",
           "sample_tokens", "save_snapshot", "stream_match_rate"]
