"""In-process EVM for contract-level verification.

The port of ``protocol_tpu/evm``: the interpreter, its assembler and
precompiles (``machine``) and the dev chain (``devchain``), copies of
the reference's whose results, gas and logs equal it.  The analog of the reference's use of an embedded revm executor to
deploy and exercise its generated Yul PLONK verifier without a chain
(circuit/src/verifier/mod.rs:117-134 ``evm_verify``, client
deploy/call utils client/src/utils.rs:60-116): a compact interpreter
covering the execution profile of verifier contracts — 256-bit stack
machine, memory, calldata, KECCAK256, the Bn254 precompiles (ecAdd,
ecMul, pairing) plus modexp, and Istanbul-flavoured gas metering so
verification cost is measurable.
"""

from .machine import EVM, Precompiles, Receipt, asm, op

__all__ = ["EVM", "Precompiles", "Receipt", "asm", "op"]
