"""Protocol error codes, wire-stable in both directions
(server/src/error.rs:6-56)."""

from __future__ import annotations

from enum import Enum


class EigenErrorCode(Enum):
    INVALID_BOOTSTRAP_PUBKEY = 0
    PROVING_ERROR = 1
    VERIFICATION_ERROR = 2
    CONNECTION_ERROR = 3
    LISTEN_ERROR = 4
    ATTESTATION_NOT_FOUND = 5
    PROOF_NOT_FOUND = 6
    INVALID_ATTESTATION = 7
    UNKNOWN = 255

    @classmethod
    def from_u8(cls, code: int) -> "EigenErrorCode":
        try:
            return cls(code)
        except ValueError:
            return cls.UNKNOWN


class EigenError(Exception):
    """Protocol exception carrying a stable u8 wire code."""

    def __init__(self, code: EigenErrorCode, message: str = ""):
        self.code = code
        super().__init__(message or code.name)

    def to_u8(self) -> int:
        return self.code.value

    @classmethod
    def invalid_attestation(cls, why: str = "") -> "EigenError":
        return cls(EigenErrorCode.INVALID_ATTESTATION, why)

    @classmethod
    def proof_not_found(cls) -> "EigenError":
        return cls(EigenErrorCode.PROOF_NOT_FOUND)

    @classmethod
    def attestation_not_found(cls) -> "EigenError":
        return cls(EigenErrorCode.ATTESTATION_NOT_FOUND)
