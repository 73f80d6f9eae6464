"""The port's PLONK key cache: its own directory and environment
variable, a warm boot that loads the compiled key instead of running
keygen again, and a refusal to load a pickle that names the reference
package's classes (its ``ProvingKey`` above all), which is recomputed
and replaced by the port's own."""

import io
import pickle
import types

import pytest

from protocol_tpu.zk import plonk as ref_plonk
from protocol_tpu.zk.kzg import Setup as RefSetup
from protocol_tpu_torch.zk import native, plonk, proof
from protocol_tpu_torch.zk.kzg import Setup
from protocol_tpu_torch.zk.proof import PlonkEpochProver


def small_prover(cache_dir) -> PlonkEpochProver:
    """The 2-peer statement (k = 13) on a seeded SRS."""
    return PlonkEpochProver(num_neighbours=2, num_iter=1, srs=Setup.generate(14, seed=b"cache"),
                            cache_dir=str(cache_dir))


def compile_stub(monkeypatch, tmp_path):
    """``_compile_cached`` on a stub prover, with keygen replaced by a
    counter: returns (call it with a cache_dir, the keygen calls)."""
    calls = []
    monkeypatch.setattr(plonk, "compile_circuit", lambda cs, srs=None, k=None: calls.append(1))
    stub = types.SimpleNamespace(_params={"num_neighbours": 2})
    srs = Setup.generate(3, seed=b"stub")
    return (lambda cache_dir=None: PlonkEpochProver._compile_cached(stub, None, srs, None, None,
                                                                    cache_dir)), calls


def test_default_directory_and_variable_are_the_ports(monkeypatch, tmp_path):
    compile_cached, calls = compile_stub(monkeypatch, tmp_path)
    assert proof.CACHE_ENV == "PROTOCOL_TPU_TORCH_CACHE"
    monkeypatch.delenv(proof.CACHE_ENV, raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    compile_cached()
    assert len(list((tmp_path / "build" / "plonk-keys").glob("plonk-pk-*.pkl"))) == 1
    monkeypatch.setenv(proof.CACHE_ENV, str(tmp_path / "env"))
    compile_cached()
    assert len(list((tmp_path / "env").glob("plonk-pk-*.pkl"))) == 1
    assert len(calls) == 2


def test_cache_key_follows_the_native_sources(monkeypatch, tmp_path):
    compile_cached, calls = compile_stub(monkeypatch, tmp_path)
    compile_cached(tmp_path / "keys")
    edited = tmp_path / "zk_runtime.cpp"
    edited.write_bytes(native.SOURCES[0].read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(native, "SOURCES", (edited,) + native.SOURCES[1:])
    compile_cached(tmp_path / "keys")
    assert len(list((tmp_path / "keys").glob("plonk-pk-*.pkl"))) == 2
    assert len(calls) == 2


def test_warm_boot_loads_the_key(monkeypatch, tmp_path):
    cold = small_prover(tmp_path)
    entries = list(tmp_path.glob("plonk-pk-*.pkl"))
    assert len(entries) == 1

    def keygen(*args, **kwargs):
        raise AssertionError("keygen ran on a warm cache")

    monkeypatch.setattr(plonk, "compile_circuit", keygen)
    warm = small_prover(tmp_path)
    assert warm.vk.digest == cold.vk.digest
    assert isinstance(warm._pk, plonk.ProvingKey)
    assert list(tmp_path.glob("plonk-pk-*.pkl")) == entries


def test_reference_key_refused_and_replaced(tmp_path):
    small_prover(tmp_path)
    (entry,) = tmp_path.glob("plonk-pk-*.pkl")
    # The reference's compiled key for the same statement and SRS,
    # planted under the port's entry name.
    from protocol_tpu.crypto import calculate_message_hash
    from protocol_tpu.crypto.eddsa import sign
    from protocol_tpu.node.attestation import Attestation
    from protocol_tpu.node.bootstrap import FIXED_SET, keyset_from_raw
    from protocol_tpu.trust.native import power_iterate
    from protocol_tpu.zk.circuit import prove_epoch_statement

    sks, pks = keyset_from_raw(FIXED_SET[:2])
    rows = [[500, 500], [500, 500]]
    _, msgs = calculate_message_hash(pks, rows)
    atts = [Attestation(sig=sign(sk, pk, m), pk=pk, neighbours=list(pks), scores=r)
            for sk, pk, m, r in zip(sks, pks, msgs, rows)]
    pub = power_iterate([1000, 1000], rows, 1, 1000)
    cs = prove_epoch_statement(atts, pub, num_neighbours=2, num_iter=1)
    ref_pk = ref_plonk.compile_circuit(cs, srs=RefSetup.generate(14, seed=b"cache"))
    entry.write_bytes(pickle.dumps(ref_pk, protocol=pickle.HIGHEST_PROTOCOL))

    again = small_prover(tmp_path)
    assert isinstance(again._pk, plonk.ProvingKey)
    assert type(again._pk).__module__ == "protocol_tpu_torch.zk.plonk"
    assert again.vk.digest == ref_pk.vk.digest
    with entry.open("rb") as f:
        assert isinstance(proof._KeyUnpickler(f).load(), plonk.ProvingKey)


@pytest.mark.parametrize("make", [lambda: ref_plonk.Domain(2), lambda: RefSetup.generate(2)],
                         ids=["plonk.Domain", "kzg.Setup"])
def test_unpickler_refuses_the_reference_package(make):
    with pytest.raises(pickle.UnpicklingError, match="reference package"):
        proof._KeyUnpickler(io.BytesIO(pickle.dumps(make()))).load()
    assert proof._KeyUnpickler(io.BytesIO(pickle.dumps(plonk.Domain(2)))).load().n == 4
