"""ops of the PyTorch port (see deepmerge_tpu_torch/__init__.py)."""
from deepmerge_tpu_torch.ops.resize import (  # noqa: F401
    resize_weights,
    crop_resize,
    area_resize,
)
from deepmerge_tpu_torch.ops.patches import (  # noqa: F401
    adaptive_scales,
    extract_multiscale_patches,
    pad_scene,
    pad_scene_device,
    scene_pad,
    slot_caps,
)
from deepmerge_tpu_torch.ops.segment import (  # noqa: F401
    segment_mean,
    pairwise_sqdist,
    edge_distances,
)
from deepmerge_tpu_torch.ops.labelprop import (  # noqa: F401
    device_merge,
    device_score_and_merge,
    merged_label_map,
)
