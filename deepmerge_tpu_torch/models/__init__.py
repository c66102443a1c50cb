"""models of the PyTorch port (see deepmerge_tpu_torch/__init__.py)."""
from deepmerge_tpu_torch.models.s2former import (  # noqa: F401
    S2Former,
    build_model,
    rel_pos_index,
    rel_pos_index_extra_token,
)
