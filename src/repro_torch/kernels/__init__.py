# ``ops.flash_attention`` is not re-exported here: the name would hide the
# ``kernels.flash_attention`` module (the kernel's wrapper).
from repro_torch.kernels.ops import sha256_digests, sha256_words  # noqa: F401
