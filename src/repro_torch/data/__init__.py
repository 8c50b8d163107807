from repro_torch.data.dataset import MemmapTokenDataset, write_token_file
from repro_torch.data.packing import pack_documents
from repro_torch.data.synthetic import SyntheticLMDataset

__all__ = ["MemmapTokenDataset", "SyntheticLMDataset", "pack_documents",
           "write_token_file"]
