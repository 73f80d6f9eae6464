"""Proof wire types, the Prover interface, the PLONK epoch prover and
the commitment prover.

``Proof``/``ProofRaw`` mirror circuit/src/lib.rs:258-292: public inputs
as field elements / 32-byte LE reprs plus opaque proof bytes, JSON round-
trippable in the same shape the reference serves from ``GET /score``.
"""

from __future__ import annotations

import json
import pickle
from dataclasses import dataclass

from ..crypto import field
from ..crypto import permute_one

#: Environment variable naming the PLONK key cache's directory
#: (:meth:`PlonkEpochProver._compile_cached`).
CACHE_ENV = "PROTOCOL_TPU_TORCH_CACHE"

#: The reference package, whose pickled keys never load here.
_FOREIGN_PACKAGE = "protocol_tpu"


class _KeyUnpickler(pickle.Unpickler):
    """Refuses a pickle that names a class of the reference package (its
    own ``ProvingKey``, for one): loading it would import that package,
    and its key is not this package's type."""

    def find_class(self, module, name):
        if module == _FOREIGN_PACKAGE or module.startswith(_FOREIGN_PACKAGE + "."):
            raise pickle.UnpicklingError(f"refusing {module}.{name} from the reference package")
        return super().find_class(module, name)


@dataclass
class Proof:
    pub_ins: list[int]
    proof: bytes

    def to_raw(self, backend: str = "") -> "ProofRaw":
        return ProofRaw(
            pub_ins=[field.to_le_bytes(x) for x in self.pub_ins],
            proof=self.proof,
            backend=backend,
        )


@dataclass
class ProofRaw:
    pub_ins: list[bytes]
    proof: bytes
    #: Which prover produced ``proof``: "plonk" / "commitment" / ""
    #: (unknown — proof from a peer that predates the tag).  Serialized
    #: as an extra JSON key; absent on reference-format payloads, so
    #: round-tripping stays wire-compatible both ways.
    backend: str = ""

    def to_proof(self) -> Proof:
        return Proof(
            pub_ins=[field.from_le_bytes(x) for x in self.pub_ins], proof=self.proof
        )

    def to_json(self) -> str:
        # serde serializes [u8; 32] and Vec<u8> as JSON integer arrays.
        obj = {
            "pub_ins": [list(x) for x in self.pub_ins],
            "proof": list(self.proof),
        }
        if self.backend:
            obj["backend"] = self.backend
        return json.dumps(obj)

    @classmethod
    def from_json(cls, s: str) -> "ProofRaw":
        obj = json.loads(s)
        return cls(
            pub_ins=[bytes(x) for x in obj["pub_ins"]],
            proof=bytes(obj["proof"]),
            backend=obj.get("backend", ""),
        )


class Prover:
    """Produces proof bytes binding public inputs to a witness."""

    name = "abstract"
    #: Wire tag served in ProofRaw.backend so clients dispatch without
    #: sniffing proof bytes.  Empty = unknown; clients fall back to
    #: shape detection.
    wire_tag = ""

    def prove(
        self, pub_ins: list[int], witness: dict, *, seed: bytes | None = None
    ) -> bytes:
        """``seed`` (optional) derives the blinding randomness
        deterministically — the async proving plane passes a
        statement-bound seed (:func:`protocol_tpu_torch.prover.jobs.job_seed`)
        so pooled and in-process proofs of the same statement are
        byte-identical.  None keeps system-RNG blinding."""
        raise NotImplementedError

    def verify(self, pub_ins: list[int], proof: bytes) -> bool:
        raise NotImplementedError


class PlonkEpochProver(Prover):
    """Real SNARK prover for the epoch statement: the EigenTrust
    circuit (zk.circuit) proved with the KZG-backed PLONK engine
    (zk.plonk) — the analog of the reference's Halo2 path behind
    ``Manager::calculate_proofs`` (manager/mod.rs:189-199 →
    verifier/mod.rs:62-83).

    Keygen runs once at construction, mirroring the reference's boot-
    time ``MANAGER_STORE`` keygen (server/src/main.rs:70-83), and is
    cached on disk (:meth:`_compile_cached`).  The compiled key depends
    only on circuit *structure*, so any valid dummy statement
    parameterizes it.  The prover runs on the host: the native runtime
    (``zk.native``) or its pure-Python fallback.
    """

    name = "plonk-kzg"
    wire_tag = "plonk"

    def __init__(
        self,
        num_neighbours: int = 5,
        num_iter: int = 10,
        initial_score: int = 1000,
        scale: int = 1000,
        srs=None,
        srs_path: str | None = None,
        k: int | None = None,
        cache_dir: str | None = None,
    ):
        from ..crypto import calculate_message_hash
        from ..crypto.eddsa import SecretKey, sign
        from ..node.attestation import Attestation
        from ..trust.native import power_iterate
        from .circuit import prove_epoch_statement
        from . import plonk

        self._params = dict(
            num_neighbours=num_neighbours,
            num_iter=num_iter,
            initial_score=initial_score,
            scale=scale,
        )
        self._plonk = plonk
        self._prove_statement = prove_epoch_statement

        n = num_neighbours
        sks = [SecretKey.random() for _ in range(n)]
        pks = [sk.public() for sk in sks]
        # Rows must sum to `scale` for total-score conservation.
        base = scale // n
        row = [base] * (n - 1) + [scale - base * (n - 1)]
        rows = [list(row) for _ in range(n)]
        _, messages = calculate_message_hash(pks, rows)
        atts = [
            Attestation(sig=sign(sk, pk, m), pk=pk, neighbours=list(pks), scores=r)
            for sk, pk, m, r in zip(sks, pks, messages, rows)
        ]
        pub = power_iterate([initial_score] * n, rows, num_iter, scale)
        self._dummy_statement = (atts, pub)
        cs = prove_epoch_statement(atts, pub, **self._params)
        if srs is None and srs_path is None:
            # A fresh random setup is fine for development, but its
            # proofs will not verify against anyone else's
            # et_verifier.bin (different vk commitments), and its
            # toxic waste lives on this machine.  Make that loud.
            import logging

            logging.getLogger(__name__).warning(
                "PLONK prover booted WITHOUT a ceremony SRS (srs_path unset): "
                "generating a dev-only random setup (cached across boots). "
                "Proofs will only verify against artifacts generated from this "
                "same setup; do not use in production."
            )
        self._pk = self._compile_cached(cs, srs, srs_path, k, cache_dir)

    def _compile_cached(self, cs, srs, srs_path, k, cache_dir):
        """Disk-cached keygen: ``compile_circuit`` is deterministic given
        the circuit structure, SRS, and k, and takes seconds at k=14 —
        the reference pays its minutes-scale Halo2 keygen on every boot
        (server/src/main.rs:70-83); a node here pays it once per
        (circuit, SRS, code) triple.  The cache key folds in a hash of
        every source the compiled key depends on (this package's zk,
        crypto and utils modules and the native sources ``zk.native``
        builds) so a change to any of them invalidates it.

        The cache lives in ``cache_dir``, else ``$PROTOCOL_TPU_TORCH_CACHE``,
        else ``build/protocol_tpu_torch/plonk-keys`` at the repository
        root — never the reference package's cache — and an entry that
        names a class of the reference package is refused unread
        (:class:`_KeyUnpickler`).

        Trust boundary: entries are pickles of the proving key — treat
        the cache directory like a key store (it is created 0700; a
        writer there can already substitute your proving key)."""
        import hashlib
        import json as _json
        import os
        import uuid
        from pathlib import Path

        from . import native as zk_native
        from . import plonk

        root = cache_dir or os.environ.get(CACHE_ENV)
        if root is None:
            root = zk_native.BUILD_DIR / "plonk-keys"
        root = Path(root)

        def load_srs():
            if srs is None and srs_path is not None:
                from .kzg import Setup

                try:
                    blob = Path(srs_path).read_bytes()
                except OSError as e:
                    raise FileNotFoundError(
                        f"SRS file {srs_path!r} (config key 'srs_path') "
                        f"could not be read: {e}"
                    ) from e
                return Setup.from_bytes(blob)
            return srs

        def open_cache_dir() -> int | None:
            """Create-then-verify the cache directory on an fd so a
            racing attacker can't swap in a loose-permission directory
            between check and use (all entry IO goes through dir_fd).
            Unpickling from a writable-by-others dir is code execution
            at boot, not just key substitution."""
            try:
                root.mkdir(parents=True, exist_ok=True, mode=0o700)
                fd = os.open(root, os.O_RDONLY | os.O_DIRECTORY)
            except OSError:
                return None
            st = os.fstat(fd)
            if st.st_uid != os.getuid() or st.st_mode & 0o077:
                try:
                    if st.st_uid == os.getuid():
                        os.fchmod(fd, 0o700)
                        return fd
                except OSError:
                    pass
                os.close(fd)
                import logging

                logging.getLogger(__name__).warning(
                    "ignoring PLONK key cache at %s: directory must be "
                    "owned by this user with mode 0700",
                    root,
                )
                return None
            return fd

        dir_fd = open_cache_dir()
        if dir_fd is None:
            return plonk.compile_circuit(cs, srs=load_srs(), k=k)

        h = hashlib.sha256()
        h.update(_json.dumps(self._params, sort_keys=True).encode())
        h.update(str(k).encode())
        if srs_path is not None and srs is None:
            h.update(b"srs-file")
            h.update(hashlib.sha256(Path(srs_path).read_bytes()).digest())
        elif srs is not None:
            # Setup objects are identified by size + a probe point (the
            # full g1 ladder is MBs; tau binds every power).
            h.update(f"srs-obj-{srs.k}-{srs.g1_powers[1]}-{srs.tau_g2}".encode())
        else:
            h.update(b"srs-dev-random")
        pkg = Path(__file__).resolve().parents[1]
        deps = sorted(
            str(p)
            for pat in ("zk/*.py", "zk/graft/*.py", "crypto/*.py", "utils/*.py")
            for p in pkg.glob(pat)
        ) + [str(p) for p in zk_native.SOURCES + zk_native.HEADERS]
        for dep in deps:
            h.update(Path(dep).read_bytes())
        key = h.hexdigest()[:32]
        name = f"plonk-pk-{key}.pkl"

        try:
            try:
                f = os.fdopen(os.open(name, os.O_RDONLY, dir_fd=dir_fd), "rb")
            except FileNotFoundError:
                pass
            else:
                try:
                    with f:
                        pk = _KeyUnpickler(f).load()
                    if isinstance(pk, plonk.ProvingKey):
                        return pk
                    raise pickle.UnpicklingError("not a proving key of this package")
                except Exception:
                    try:
                        os.unlink(name, dir_fd=dir_fd)  # corrupt: recompute
                    except OSError:
                        pass

            pk = plonk.compile_circuit(cs, srs=load_srs(), k=k)
            try:
                tmp = f".{name}.{uuid.uuid4().hex}.tmp"
                with os.fdopen(
                    os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600, dir_fd=dir_fd),
                    "wb",
                ) as f:
                    pickle.dump(pk, f, protocol=pickle.HIGHEST_PROTOCOL)
                os.rename(tmp, name, src_dir_fd=dir_fd, dst_dir_fd=dir_fd)
            except OSError:
                pass  # cache is best-effort; proving works without it
            return pk
        finally:
            os.close(dir_fd)

    @property
    def vk(self):
        return self._pk.vk

    #: Proofs use the keccak transcript so they verify on-chain through
    #: the generated EVM verifier, like the reference's EvmTranscript
    #: proofs (verifier/mod.rs:70-83).
    TRANSCRIPT = "keccak"

    def prove(
        self, pub_ins: list[int], witness: dict, *, seed: bytes | None = None
    ) -> bytes:
        # Reuse a pre-synthesized constraint system (the manager's
        # check_circuit pass) rather than rebuilding the k=14 circuit.
        cs = witness.get("cs")
        if cs is None:
            cs = self._prove_statement(
                witness["attestations"], pub_ins, **self._params
            )
        return self._plonk.prove(
            self._pk, cs, pub_ins, seed=seed, transcript=self.TRANSCRIPT
        )

    def verify(self, pub_ins: list[int], proof: bytes) -> bool:
        return self._plonk.verify(
            self._pk.vk, pub_ins, proof, transcript=self.TRANSCRIPT
        )

    def generate_verifier_artifact(self):
        """Generate the EVM verifier contract for this circuit (the
        gen_evm_verifier_code analog): proves the keygen dummy
        statement once to pin the quotient-chunk count, then emits
        bytecode.  Returns (GeneratedVerifier, sample_pub_ins,
        sample_proof) — the sample is expensive (a full prove), so
        callers reuse it rather than proving again."""
        from .evm_verifier import generate_evm_verifier, infer_n_t

        atts, pub = self._dummy_statement
        cs = self._prove_statement(atts, pub, **self._params)
        sample = self._plonk.prove(self._pk, cs, pub, transcript=self.TRANSCRIPT)
        n_t = infer_n_t(self._pk.vk, sample)
        gen = generate_evm_verifier(
            self._pk.vk, n_t, self._params["num_neighbours"]
        )
        return gen, pub, sample


class PoseidonCommitmentProver(Prover):
    """Poseidon commitment chain over the public inputs and witness ops.

    NOT zero-knowledge and NOT succinctness-equivalent to the reference's
    KZG proof — a deterministic binding commitment standing in for the
    PLONK prover.  The wire shape (opaque bytes alongside pub_ins)
    matches, so the node/client flow is end-to-end testable.  The
    domain tag is the reference's, so both packages commit to the same
    bytes.
    """

    name = "poseidon-commitment"
    wire_tag = "commitment"
    DOMAIN = (
        int.from_bytes(b"protocol_tpu.commit.v1".ljust(32, b"\0"), "little") % field.MODULUS
    )

    def _digest(self, pub_ins: list[int], witness: dict) -> int:
        acc = self.DOMAIN
        for x in pub_ins:
            acc = permute_one([acc, x, 1, 0, 0])[0]
        for row in witness.get("ops", []):
            for x in row:
                acc = permute_one([acc, x, 2, 0, 0])[0]
        return acc

    def prove(
        self, pub_ins: list[int], witness: dict, *, seed: bytes | None = None
    ) -> bytes:
        # Commitment proofs are deterministic already; seed is accepted
        # for interface uniformity and ignored.
        return field.to_le_bytes(self._digest(pub_ins, witness)) + json.dumps(
            {"ops": [[int(x) for x in row] for row in witness.get("ops", [])]}
        ).encode()

    def verify(self, pub_ins: list[int], proof: bytes) -> bool:
        if len(proof) < 32:
            return False
        digest, payload = proof[:32], proof[32:]
        try:
            witness = json.loads(payload.decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            return False
        return digest == field.to_le_bytes(self._digest(pub_ins, witness))
