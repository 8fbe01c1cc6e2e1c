"""Tree utilities of the training port (``repro/utils``)."""

from repro_torch.utils.trees import (  # noqa: F401
    global_norm,
    tree_bytes,
    tree_count,
    tree_flatten_with_names,
    tree_leaves,
    tree_map,
    tree_map_with_path_names,
    tree_unflatten_like,
)
