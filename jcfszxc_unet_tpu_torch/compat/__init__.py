"""Weight interchange of the port: JAX variables and msgpack ``.ckpt``
files (``from_jax``, ``msgpack``), reference ``.pth`` import and export
(``torch_import``, ``torch_export``)."""

from jcfszxc_unet_tpu_torch.compat.from_jax import (  # noqa: F401
    MappingError,
    state_dict_from_jax,
)
from jcfszxc_unet_tpu_torch.compat.torch_export import (  # noqa: F401
    export_torch_checkpoint,
    export_torch_state_dict,
)
from jcfszxc_unet_tpu_torch.compat.torch_import import (  # noqa: F401
    EXPECTED_UNUSED,
    import_torch_checkpoint,
    load_pth_state_dict,
)
