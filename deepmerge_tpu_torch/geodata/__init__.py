from deepmerge_tpu_torch.geodata.types import RegionTable, EdgeList, Scene  # noqa: F401
from deepmerge_tpu_torch.geodata.synthetic import generate_scene, make_training_pairs  # noqa: F401
