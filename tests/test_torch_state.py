"""The port's copied host legs against the JAX package's: blob share
commitments (native and hashlib legs), the tx wire format, RFC-6979
signatures, and the port's own build of the native library."""

import numpy as np
import pytest

from celestia_tpu.da import blob as jax_blob
from celestia_tpu.da import inclusion as jax_inclusion
from celestia_tpu.da import namespace as jax_namespace
from celestia_tpu.state import tx as jax_tx
from celestia_tpu.utils import native as jax_native
from celestia_tpu.utils import secp256k1 as jax_secp
from celestia_tpu_torch.appconsts import (
    CONTINUATION_SPARSE_SHARE_CONTENT_SIZE,
    FIRST_SPARSE_SHARE_CONTENT_SIZE,
)
from celestia_tpu_torch.da import blob as port_blob
from celestia_tpu_torch.da import inclusion
from celestia_tpu_torch.da import namespace as port_namespace
from celestia_tpu_torch.da.shares import sparse_shares_needed
from celestia_tpu_torch.state import tx as port_tx
from celestia_tpu_torch.utils import native
from celestia_tpu_torch.utils import secp256k1 as port_secp


def _size_of(shares: int) -> int:
    """The largest blob that fills exactly ``shares`` sparse shares."""
    return FIRST_SPARSE_SHARE_CONTENT_SIZE + (shares - 1) * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE


# blob sizes at the edges of the mountain ranges: share counts at and one
# past powers of two, below and above the subtree-root threshold (64), and
# one byte across a share boundary
EDGE_SHARES = (1, 2, 3, 4, 5, 8, 9, 16, 17, 63, 64, 65, 128, 129, 255, 256, 257, 1024, 1025)
EDGE_SIZES = sorted({1} | {_size_of(n) for n in EDGE_SHARES}
                    | {_size_of(n) + 1 for n in EDGE_SHARES})


def _blobs(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for size in EDGE_SIZES:
        ns_id, data = b"\x01" + rng.bytes(9), rng.bytes(size)
        out.append((
            port_blob.Blob(port_namespace.Namespace.v0(ns_id), data),
            jax_blob.Blob(jax_namespace.Namespace.v0(ns_id), data),
        ))
    return out


def test_edge_sizes_span_the_mountain_ranges():
    counts = {sparse_shares_needed(s) for s in EDGE_SIZES}
    assert set(EDGE_SHARES) <= counts and 1026 in counts


@pytest.mark.parametrize("leg", ["native", "hashlib"])
def test_create_commitment_matches_jax(leg, monkeypatch):
    if leg == "native":
        assert native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    inclusion._COMMITMENT_CACHE.clear()
    try:
        for port_b, jax_b in _blobs(1 if leg == "native" else 2):
            want = jax_inclusion.create_commitment(jax_b)
            assert inclusion.create_commitment(port_b) == want, len(port_b.data)
    finally:
        inclusion._COMMITMENT_CACHE.clear()


def test_warm_commitments_match_jax():
    inclusion._COMMITMENT_CACHE.clear()
    pairs = _blobs(3)
    inclusion.warm_commitments([p for p, _ in pairs])
    assert len(inclusion._COMMITMENT_CACHE) == len(pairs)
    for port_b, jax_b in pairs:
        assert inclusion.create_commitment(port_b) == jax_inclusion.create_commitment(jax_b)
    inclusion._COMMITMENT_CACHE.clear()


def _tx_pair(seed: bytes, memo: str):
    """The same signed PFB tx built with each package's classes."""
    out = []
    for tx_mod, secp in ((port_tx, port_secp), (jax_tx, jax_secp)):
        key = secp.PrivateKey.from_seed(seed)
        addr = key.public_key().address()
        msgs = (
            tx_mod.MsgSend(addr, b"\x07" * 20, 12345),
            tx_mod.MsgPayForBlobs(
                signer=addr, namespaces=(b"\x00" * 19 + b"\x01" + b"\x02" * 9,),
                blob_sizes=(700,), share_commitments=(b"\x09" * 32,), share_versions=(0,),
            ),
        )
        tx = tx_mod.Tx(msgs, tx_mod.Fee(2000, 90_000), key.public_key().compressed(), 3, 1,
                       memo=memo, timeout_height=99)
        out.append(tx.signed(key, "parity-1"))
    return out


@pytest.mark.parametrize("seed", [b"alice", b"bob", b"carol"])
def test_tx_and_blob_tx_bytes_and_signatures_match_jax(seed):
    port, ref = _tx_pair(seed, memo=seed.decode())
    assert port.signature == ref.signature and len(port.signature) == 64
    assert port.marshal() == ref.marshal()
    assert port.hash() == ref.hash()
    assert port_tx.unmarshal_tx(ref.marshal()) == port
    assert port.verify_signature("parity-1")
    data = bytes(range(256)) * 3
    ns_id = b"\x01" + seed.ljust(9, b"\x00")
    port_btx = port_blob.BlobTx(port.marshal(), (
        port_blob.Blob(port_namespace.Namespace.v0(ns_id), data),))
    ref_btx = jax_blob.BlobTx(ref.marshal(), (
        jax_blob.Blob(jax_namespace.Namespace.v0(ns_id), data),))
    assert port_btx.marshal() == ref_btx.marshal()
    assert port_blob.unmarshal_blob_tx(ref_btx.marshal()) == port_btx
    # RFC 6979: the signature over any message is the same in both packages
    msg = b"rfc6979|" + seed
    assert (port_secp.PrivateKey.from_seed(seed).sign(msg)
            == jax_secp.PrivateKey.from_seed(seed).sign(msg))


def test_native_library_builds_to_its_own_path(tmp_path, monkeypatch):
    root = native._REPO_ROOT
    assert native._SO == root / "build" / "torch_native" / "celestia_native.so"
    assert native._SO != jax_native._SO
    assert native.available() and native._SO.exists()
    # a rebuild writes a temporary file and moves it into place
    target = tmp_path / "out" / "celestia_native.so"
    monkeypatch.setattr(native, "_SO", target)
    assert native._build()
    assert target.exists() and sorted(p.name for p in target.parent.iterdir()) == [target.name]
