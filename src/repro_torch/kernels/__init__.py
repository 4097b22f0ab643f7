from repro_torch.kernels.ops import sha256_digests, sha256_words  # noqa: F401
