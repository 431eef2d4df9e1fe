"""AES-256-GCM secret cipher + encrypted-at-rest secret store (the JAX
package's gateway/security.py; a store file written by either package
decrypts in the other).

Behavioral parity with the reference's security adapter
(internal/adapters/security/cipher.go:92-141): key must be
exactly 32 bytes (cipher.go:15-23), encryption uses a random 12-byte GCM
nonce prepended to the sealed ciphertext (cipher.go:25-56), decryption
splits the nonce back off and authenticates (cipher.go:61-83), and the
batch APIs are sequential loops over the unary ones (cipher.go:110-141).

Where the reference leaves the adapter as dead code (nothing imports it —
SURVEY.md §2 "Security cipher"), this framework actually consumes it: the
`secret_id` field the contract plumbs end-to-end (server.go:31) resolves
through a SecretStore whose values live encrypted at rest, and the gateway
mounts the store from POLYKEY_SECRET_KEY / POLYKEY_SECRETS_FILE
(torch_service.py). Resolution never fails a request — unknown ids behave
exactly as the reference (which ignores secret_id entirely).
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional

NONCE_SIZE = 12  # GCM standard nonce size, matches Go's gcm.NonceSize()
KEY_SIZE = 32    # AES-256 (cipher.go:15-23 rejects anything else)


class CipherError(ValueError):
    pass


class SecretCipher:
    """AES-256-GCM with nonce-prepended framing."""

    def __init__(self, key: bytes):
        if len(key) != KEY_SIZE:
            raise CipherError(
                f"key must be exactly {KEY_SIZE} bytes, got {len(key)}"
            )
        try:
            from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        except ImportError as e:
            # Gate, don't crash opaquely: some images omit the optional
            # `cryptography` wheel. The import is lazy (here, not module
            # top) precisely so a deployment that never configures a
            # secret key pays nothing and never sees this; one that DOES
            # gets an actionable error instead of a bare ImportError
            # from deep inside a request path.
            raise CipherError(
                "the 'cryptography' package is not installed; the "
                "AES-256-GCM secret store is unavailable in this "
                "environment (install cryptography>=41 to enable "
                "POLYKEY_SECRET_KEY / POLYKEY_SECRETS_FILE)"
            ) from e

        self._aead = AESGCM(key)

    @classmethod
    def from_hex(cls, hex_key: str) -> "SecretCipher":
        try:
            key = bytes.fromhex(hex_key.strip())
        except ValueError as e:
            raise CipherError(f"key is not valid hex: {e}") from None
        return cls(key)

    def encrypt(self, plaintext: bytes) -> bytes:
        """nonce || ciphertext || tag (the reference's Seal framing)."""
        nonce = os.urandom(NONCE_SIZE)
        return nonce + self._aead.encrypt(nonce, plaintext, None)

    def decrypt(self, blob: bytes) -> bytes:
        if len(blob) < NONCE_SIZE + 16:  # nonce + GCM tag minimum
            raise CipherError("ciphertext too short")
        from cryptography.exceptions import InvalidTag

        nonce, sealed = blob[:NONCE_SIZE], blob[NONCE_SIZE:]
        try:
            return self._aead.decrypt(nonce, sealed, None)
        except InvalidTag:
            raise CipherError("decryption failed: authentication tag mismatch")

    # Sequential loops, matching BatchEncrypt/BatchDecrypt (cipher.go:110-141).
    def encrypt_batch(self, plaintexts: list[bytes]) -> list[bytes]:
        return [self.encrypt(p) for p in plaintexts]

    def decrypt_batch(self, blobs: list[bytes]) -> list[bytes]:
        return [self.decrypt(b) for b in blobs]


class SecretStore:
    """secret_id → plaintext, held encrypted at rest.

    File format: JSON object of {secret_id: base64(nonce||ct||tag)}.
    """

    def __init__(self, cipher: SecretCipher):
        self._cipher = cipher
        self._blobs: dict[str, bytes] = {}

    def put(self, secret_id: str, plaintext: str) -> None:
        self._blobs[secret_id] = self._cipher.encrypt(plaintext.encode())

    def resolve(self, secret_id: str) -> Optional[str]:
        blob = self._blobs.get(secret_id)
        if blob is None:
            return None
        return self._cipher.decrypt(blob).decode()

    def __contains__(self, secret_id: str) -> bool:
        return secret_id in self._blobs

    def __len__(self) -> int:
        return len(self._blobs)

    def save(self, path: str) -> None:
        payload = {
            sid: base64.b64encode(blob).decode()
            for sid, blob in self._blobs.items()
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)

    def load(self, path: str) -> None:
        with open(path) as f:
            payload = json.load(f)
        for sid, b64 in payload.items():
            self._blobs[sid] = base64.b64decode(b64)

    @classmethod
    def from_env(cls, logger=None) -> Optional["SecretStore"]:
        """POLYKEY_SECRET_KEY (64 hex chars) turns the store on;
        POLYKEY_SECRETS_FILE optionally preloads encrypted secrets."""
        hex_key = os.environ.get("POLYKEY_SECRET_KEY")
        if not hex_key:
            return None
        store = cls(SecretCipher.from_hex(hex_key))
        path = os.environ.get("POLYKEY_SECRETS_FILE")
        if path and os.path.exists(path):
            store.load(path)
            if logger is not None:
                logger.info("secret store loaded", path=path,
                            secrets=len(store))
        return store


def _main() -> int:
    """Operator helper: seed an encrypted secrets file.

    usage: python -m polykey_tpu_torch.gateway.security put <file> <id> <value>
           (POLYKEY_SECRET_KEY must hold the 64-hex-char key)
    """
    import sys

    if len(sys.argv) != 5 or sys.argv[1] != "put":
        print(_main.__doc__, file=sys.stderr)
        return 2
    _, _, path, sid, value = sys.argv
    store = SecretStore(SecretCipher.from_hex(os.environ["POLYKEY_SECRET_KEY"]))
    if os.path.exists(path):
        store.load(path)
    store.put(sid, value)
    store.save(path)
    print(f"stored {sid!r} in {path} ({len(store)} secrets)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
