"""The port's ``BlockPayload`` carries the reference's fields, and its
``certificate_digest`` commits a certificate as the reference does."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.chain import workload as jworkload  # noqa: E402
from repro_torch.chain import workload  # noqa: E402


def _default(field):
    if field.default is not dataclasses.MISSING:
        return field.default
    if field.default_factory is not dataclasses.MISSING:
        return field.default_factory()
    return dataclasses.MISSING


def test_payload_fields_and_certificate_digest_match_the_reference():
    ours = dataclasses.fields(workload.BlockPayload)
    theirs = dataclasses.fields(jworkload.BlockPayload)
    assert [f.name for f in ours] == [f.name for f in theirs]
    for mine, ref in zip(ours, theirs):
        assert _default(mine) == _default(ref), mine.name
    cert = np.random.RandomState(16).bytes(64)
    for c in (None, b"", cert):
        assert workload.certificate_digest(c) \
            == jworkload.certificate_digest(c)
    assert workload.certificate_digest(None) == ""
