from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged import BlockPool, blocks_for, kv_token_bytes
from repro_torch.serve.sampling import sample_tokens

__all__ = ["BlockPool", "Request", "ServeEngine", "blocks_for",
           "kv_token_bytes", "sample_tokens"]
