"""Keys, addresses, digests, signatures (paper §IV-A, Table I).

The paper allows "either one of the mainstream asymmetric encryption methods,
such as ECDSA and RSA". No crypto package ships in this container, so we
implement textbook RSA signing over sha256 digests (Miller-Rabin keygen,
sig = H^d mod n). The interface (generate_keypair / sign / verify / address)
isolates the scheme so a hardened ECDSA can be dropped in.

Model payloads are identified by *fingerprints*: per-leaf u32 checksums
of the values (see ``fingerprint_tree``), whose sha256 is signed.
Copy of the JAX package's module; ``fingerprint_tree`` walks the port's
params dicts and reads each tensor back to the host.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import secrets
from typing import Any

import numpy as np
import torch

from repro_torch import tree

_RSA_BITS = 1024
_E = 65537


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def hash_fields(*fields: Any) -> str:
    """Canonical digest of heterogeneous fields (paper: hash(content))."""
    blob = json.dumps([str(f) for f in fields], separators=(",", ":")).encode()
    return sha256_hex(blob)


# ------------------------------------------------------------------ RSA keygen
def _is_probable_prime(n: int, rounds: int = 20) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        n = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(n):
            return n


@dataclasses.dataclass(frozen=True)
class KeyPair:
    n: int
    e: int
    d: int

    @property
    def public_key(self) -> str:
        return f"{self.n:x}:{self.e:x}"

    @property
    def address(self) -> str:
        """address_node = hash(pub_key_node) (paper §IV-A1)."""
        return sha256_hex(self.public_key.encode())


def generate_keypair(bits: int = _RSA_BITS) -> KeyPair:
    while True:
        p = _random_prime(bits // 2)
        q = _random_prime(bits // 2)
        if p == q:
            continue
        n = p * q
        phi = (p - 1) * (q - 1)
        if phi % _E == 0:
            continue
        d = pow(_E, -1, phi)
        return KeyPair(n=n, e=_E, d=d)


def sign(key: KeyPair, digest_hex: str) -> str:
    h = int(digest_hex, 16) % key.n
    return f"{pow(h, key.d, key.n):x}"


def verify(public_key: str, digest_hex: str, signature_hex: str) -> bool:
    try:
        n_hex, e_hex = public_key.split(":")
        n, e = int(n_hex, 16), int(e_hex, 16)
        h = int(digest_hex, 16) % n
        return pow(int(signature_hex, 16), e, n) == h
    except (ValueError, AttributeError):
        return False


# ------------------------------------------------------- model fingerprinting
# ------------------------------------------------------- model fingerprinting
def _host_array(x) -> np.ndarray:
    """A tensor's values as numpy on the host (float leaves as fp32, which is
    what ``fingerprint_array`` hashes anyway; numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point():
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


def fingerprint_array(x) -> int:
    """Cheap order-sensitive u32 checksum of an array, hashed on the host."""
    a = _host_array(x)
    b = a.astype(np.float32, copy=False).tobytes() if a.dtype.kind == "f" else a.tobytes()
    return int.from_bytes(hashlib.sha256(b).digest()[:4], "big")


def fingerprint_tree(params) -> str:
    """sha256 over per-leaf checksums (leaves in sorted-key order, as in the
    JAX package) — the transaction's ml_model identity. Equal params give
    the JAX package's fingerprint."""
    sums = [fingerprint_array(x) for x in tree.leaves(params)]
    return sha256_hex(np.asarray(sums, np.uint64).tobytes())
