"""Compact sparse Merkle tree with content-addressed nodes.

Fills the role IAVL plays in the reference (the commit-multistore mounted
at app/app.go:242): an incrementally-maintained
authenticated map per module store, so a commit costs O(writes * log N)
instead of rehashing all state, and any (key, value) can be proven against
the store root — which in turn folds into the block's app hash.

Design (tpu-repo-native, not an IAVL port):
- keys are placed at the path given by the bits of sha256(key); a subtree
  holding exactly one key is collapsed to a single leaf node (so depth is
  ~log2(N) expected, not 256);
- nodes are CONTENT-ADDRESSED: node_hash -> encoding in a plain dict.
  Updates insert new nodes and never mutate old ones, so every historical
  root stays readable for pinned-height proofs at zero copying cost, and
  pruning is a reachability sweep from the roots still retained;
- proofs are the sibling hashes along the search path.  Non-membership is
  proven by an empty slot or by a colliding-prefix leaf with a different
  key hash.

Everything here is a pure function over (nodes, root); the client-side
verifiers at the bottom need no node store at all.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

EMPTY_ROOT = b"\x00" * 32

_LEAF_TAG = b"\x00"
_INNER_TAG = b"\x01"


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def key_hash(key: bytes) -> bytes:
    return _sha(key)


def value_hash(value: bytes) -> bytes:
    return _sha(value)


def leaf_hash(kh: bytes, vh: bytes) -> bytes:
    return _sha(_LEAF_TAG + kh + vh)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha(_INNER_TAG + left + right)


def _bit(kh: bytes, depth: int) -> int:
    return (kh[depth >> 3] >> (7 - (depth & 7))) & 1


def _put_leaf(nodes: Dict[bytes, bytes], kh: bytes, vh: bytes) -> bytes:
    h = leaf_hash(kh, vh)
    nodes[h] = _LEAF_TAG + kh + vh
    return h


def _put_inner(nodes: Dict[bytes, bytes], left: bytes, right: bytes) -> bytes:
    h = inner_hash(left, right)
    nodes[h] = _INNER_TAG + left + right
    return h


def _node(nodes: Dict[bytes, bytes], h: bytes) -> bytes:
    if h == EMPTY_ROOT:
        raise KeyError("empty subtree has no node")
    enc = nodes.get(h)
    if enc is None:
        raise KeyError(f"missing merkle node {h.hex()} (pruned?)")
    return enc


def _walk(
    nodes: Dict[bytes, bytes], root: bytes, kh: bytes
) -> Tuple[List[Tuple[bytes, int]], bytes]:
    """Descend from root along kh's bits through inner nodes.

    Returns (stack, terminal) where stack is [(sibling_hash, my_bit), ...]
    in root->down order and terminal is EMPTY_ROOT or a leaf hash.
    """
    stack: List[Tuple[bytes, int]] = []
    cur = root
    depth = 0
    while cur != EMPTY_ROOT:
        enc = _node(nodes, cur)
        if enc[0:1] == _LEAF_TAG:
            break
        left, right = enc[1:33], enc[33:65]
        b = _bit(kh, depth)
        if b == 0:
            stack.append((right, 0))
            cur = left
        else:
            stack.append((left, 1))
            cur = right
        depth += 1
    return stack, cur


def _rebuild(
    nodes: Dict[bytes, bytes], stack: List[Tuple[bytes, int]], h: bytes
) -> bytes:
    """Fold the replacement subtree hash back up through the stack,
    collapsing inner nodes whose only content is a single leaf."""
    for sibling, bit in reversed(stack):
        if sibling == EMPTY_ROOT and (
            h == EMPTY_ROOT or _node(nodes, h)[0:1] == _LEAF_TAG
        ):
            # an inner node over (leaf, empty) collapses to the leaf;
            # over (empty, empty) it collapses to empty
            continue
        if h == EMPTY_ROOT and _node(nodes, sibling)[0:1] == _LEAF_TAG:
            # the sibling leaf floats up regardless of which side it was on
            h = sibling
            continue
        h = _put_inner(nodes, h, sibling) if bit == 0 else _put_inner(
            nodes, sibling, h
        )
    return h


def smt_update(
    nodes: Dict[bytes, bytes], root: bytes, kh: bytes, vh: bytes
) -> bytes:
    """Set kh -> vh; returns the new root.  O(depth)."""
    stack, terminal = _walk(nodes, root, kh)
    if terminal == EMPTY_ROOT:
        return _rebuild(nodes, stack, _put_leaf(nodes, kh, vh))
    enc = _node(nodes, terminal)
    other_kh = enc[1:33]
    if other_kh == kh:
        return _rebuild(nodes, stack, _put_leaf(nodes, kh, vh))
    # two distinct keys share a prefix: extend the path to their first
    # diverging bit, hanging empties in between
    depth = len(stack)
    d = depth
    while _bit(kh, d) == _bit(other_kh, d):
        d += 1
    new_leaf = _put_leaf(nodes, kh, vh)
    if _bit(kh, d) == 0:
        h = _put_inner(nodes, new_leaf, terminal)
    else:
        h = _put_inner(nodes, terminal, new_leaf)
    for dd in range(d - 1, depth - 1, -1):
        if _bit(kh, dd) == 0:
            h = _put_inner(nodes, h, EMPTY_ROOT)
        else:
            h = _put_inner(nodes, EMPTY_ROOT, h)
    return _rebuild(nodes, stack, h)


def smt_delete(nodes: Dict[bytes, bytes], root: bytes, kh: bytes) -> bytes:
    """Remove kh if present; returns the new root."""
    stack, terminal = _walk(nodes, root, kh)
    if terminal == EMPTY_ROOT:
        return root
    if _node(nodes, terminal)[1:33] != kh:
        return root  # a different key occupies the slot; nothing to delete
    return _rebuild(nodes, stack, EMPTY_ROOT)


def smt_get(
    nodes: Dict[bytes, bytes], root: bytes, kh: bytes
) -> Optional[bytes]:
    _, terminal = _walk(nodes, root, kh)
    if terminal == EMPTY_ROOT:
        return None
    enc = _node(nodes, terminal)
    if enc[1:33] != kh:
        return None
    return enc[33:65]


def smt_build(
    nodes: Dict[bytes, bytes], items: Iterable[Tuple[bytes, bytes]]
) -> bytes:
    """Build a tree from (key_hash, value_hash) pairs; returns the root."""
    root = EMPTY_ROOT
    for kh, vh in items:
        root = smt_update(nodes, root, kh, vh)
    return root


def smt_prove(
    nodes: Dict[bytes, bytes], root: bytes, kh: bytes
) -> Tuple[List[bytes], Optional[Tuple[bytes, bytes]]]:
    """Proof for kh under root: (siblings root->down, terminal leaf).

    leaf is None when the search path ends in an empty slot (pure
    non-membership), else the (key_hash, value_hash) of the leaf found
    there — which proves membership if its key_hash == kh and
    non-membership otherwise.
    """
    stack, terminal = _walk(nodes, root, kh)
    siblings = [s for s, _ in stack]
    if terminal == EMPTY_ROOT:
        return siblings, None
    enc = _node(nodes, terminal)
    return siblings, (enc[1:33], enc[33:65])


def smt_reachable(nodes: Dict[bytes, bytes], roots: Iterable[bytes]) -> Set[bytes]:
    """All node hashes reachable from the given roots (for pruning)."""
    seen: Set[bytes] = set()
    frontier = [r for r in roots if r != EMPTY_ROOT]
    while frontier:
        h = frontier.pop()
        if h in seen:
            continue
        seen.add(h)
        enc = nodes.get(h)
        if enc is None or enc[0:1] == _LEAF_TAG:
            continue
        for child in (enc[1:33], enc[33:65]):
            if child != EMPTY_ROOT and child not in seen:
                frontier.append(child)
    return seen


# ---------------------------------------------------------------------------
# client-side verification (no node store needed)
# ---------------------------------------------------------------------------


def fold_path(
    kh: bytes, siblings: List[bytes], terminal: bytes
) -> bytes:
    """Recompute the root from a terminal subtree hash and the sibling
    path.  The terminal sits at depth len(siblings); position bits come
    from kh (identical to the found leaf's bits over the shared prefix)."""
    h = terminal
    for depth in range(len(siblings) - 1, -1, -1):
        sib = siblings[depth]
        if _bit(kh, depth) == 0:
            h = inner_hash(h, sib)
        else:
            h = inner_hash(sib, h)
    return h


def verify_membership(
    root: bytes,
    key: bytes,
    value: bytes,
    siblings: List[bytes],
    leaf: Optional[Tuple[bytes, bytes]],
) -> bool:
    """True iff (key, value) is committed under root."""
    if leaf is None:
        return False
    kh = key_hash(key)
    lk, lv = leaf
    if lk != kh or lv != value_hash(value):
        return False
    return fold_path(kh, siblings, leaf_hash(lk, lv)) == root


def verify_non_membership(
    root: bytes,
    key: bytes,
    siblings: List[bytes],
    leaf: Optional[Tuple[bytes, bytes]],
) -> bool:
    """True iff key is absent under root."""
    kh = key_hash(key)
    if leaf is None:
        return fold_path(kh, siblings, EMPTY_ROOT) == root
    lk, lv = leaf
    if lk == kh:
        return False
    # the occupying leaf must actually lie on kh's search path
    for depth in range(len(siblings)):
        if _bit(lk, depth) != _bit(kh, depth):
            return False
    return fold_path(kh, siblings, leaf_hash(lk, lv)) == root


def store_roots_hash(roots: Dict[str, bytes]) -> bytes:
    """App hash = hash of the sorted (store name, store root) pairs —
    the root-of-store-roots the reference's commit multistore produces."""
    h = hashlib.sha256()
    for name in sorted(roots):
        h.update(_sha(name.encode()))
        h.update(roots[name])
    return h.digest()


def verify_query_proof(proof: dict, trusted_app_hash: bytes) -> bool:
    """Client-side verification of a MultiStore.prove() result against a
    trusted app hash (the block header's).  Checks, in order: the store
    roots fold to the app hash; the claimed store root is among them; and
    the (key, value) is proven present — or, for value None, absent —
    under that store root."""
    store_roots = {
        n: bytes.fromhex(r) for n, r in proof["store_roots"].items()
    }
    if store_roots_hash(store_roots) != trusted_app_hash:
        return False
    root = store_roots.get(proof["store"])
    if root is None:
        return False
    key = bytes.fromhex(proof["key"])
    siblings = [bytes.fromhex(s) for s in proof["siblings"]]
    leaf = (
        (bytes.fromhex(proof["leaf"][0]), bytes.fromhex(proof["leaf"][1]))
        if proof.get("leaf")
        else None
    )
    if proof["value"] is None:
        return verify_non_membership(root, key, siblings, leaf)
    return verify_membership(
        root, key, bytes.fromhex(proof["value"]), siblings, leaf
    )
