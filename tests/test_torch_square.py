"""The port's copies of the host-side square construction
(celestia_tpu_torch.da.square / shares / blob / namespace) against the
JAX package's: the same seeded transaction stream must give identical
shares and block transactions, on the proposer (build) and validator
(construct) paths.
"""

import numpy as np
import pytest

from celestia_tpu.da import blob as jblob
from celestia_tpu.da import square as jsquare
from celestia_tpu.da.namespace import Namespace as JNamespace
from celestia_tpu_torch import appconsts
from celestia_tpu_torch.da import blob, square
from celestia_tpu_torch.da.namespace import Namespace


def _tx_stream(seed: int, n: int, max_blob: int):
    """Seeded mixed stream: plain txs and BlobTx envelopes with 1-3 blobs
    under random version-0 namespaces, built with both packages' types."""
    rng = np.random.default_rng(seed)
    ours, theirs = [], []
    for _ in range(n):
        inner = rng.bytes(int(rng.integers(250, 401)))
        if rng.random() < 0.2:
            ours.append(inner)
            theirs.append(inner)
            continue
        specs = [
            (b"\x01" + rng.bytes(9), rng.bytes(int(rng.integers(1, max_blob))))
            for _ in range(int(rng.integers(1, 4)))
        ]
        ours.append(
            blob.BlobTx(inner, tuple(blob.Blob(Namespace.v0(ns), d) for ns, d in specs)).marshal()
        )
        theirs.append(
            jblob.BlobTx(inner, tuple(jblob.Blob(JNamespace.v0(ns), d) for ns, d in specs)).marshal()
        )
    return ours, theirs


@pytest.mark.parametrize("max_size", [8, 16, appconsts.DEFAULT_GOV_MAX_SQUARE_SIZE])
def test_build_and_construct_match_jax(max_size):
    ours, theirs = _tx_stream(max_size, 60, 6000 * max_size // 8)
    assert ours == theirs  # identical wire bytes from both packages' types
    sq, block_txs, wrappers = square.build(ours, max_square_size=max_size)
    jsq, jblock_txs, jwrappers = jsquare.build(theirs, max_square_size=max_size)
    assert sq.size == jsq.size
    assert block_txs == jblock_txs
    assert [w.marshal() for w in wrappers] == [w.marshal() for w in jwrappers]
    np.testing.assert_array_equal(sq.to_array(), jsq.to_array())
    vsq, vtxs, _ = square.construct(block_txs, max_square_size=max_size)
    jvsq, jvtxs, _ = jsquare.construct(jblock_txs, max_square_size=max_size)
    assert vtxs == jvtxs == block_txs
    np.testing.assert_array_equal(vsq.to_array(), jvsq.to_array())
    np.testing.assert_array_equal(vsq.to_array(), sq.to_array())


def test_construct_overflow_raises_like_jax():
    ours, _ = _tx_stream(5, 40, 20000)
    sq, block_txs, _ = square.build(ours, max_square_size=8)
    with pytest.raises(ValueError):
        square.construct(block_txs, max_square_size=sq.size // 2)
    with pytest.raises(ValueError):
        jsquare.construct(block_txs, max_square_size=sq.size // 2)


def test_blob_tx_wire_form_crosses_packages():
    ours, theirs = _tx_stream(9, 10, 3000)
    for raw in ours:
        a, b = blob.unmarshal_blob_tx(raw), jblob.unmarshal_blob_tx(raw)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.tx == b.tx
            assert [(x.namespace.raw, x.data) for x in a.blobs] == [
                (x.namespace.raw, x.data) for x in b.blobs
            ]
