"""The port's own copy of ``repro.data.svm_suite`` gives the reference's
datasets and fold chunks bit for bit."""
import numpy as np
import pytest

from repro.data import svm_suite as ref_suite
from repro.data import tokens as ref_tokens
from repro_torch.convert import dataset_from_reference
from repro_torch.data import svm_suite as port_suite
from repro_torch.data import tokens as port_tokens


@pytest.mark.parametrize("name", ref_suite.DATASETS)
@pytest.mark.parametrize("n_override,seed", [(None, 0), (150, 3)])
def test_make_dataset_bitwise(name, n_override, seed):
    r = ref_suite.make_dataset(name, seed=seed, n_override=n_override)
    p = port_suite.make_dataset(name, seed=seed, n_override=n_override)
    assert (p.name, p.C, p.gamma) == (r.name, r.C, r.gamma)
    assert p.X.dtype == r.X.dtype and p.y.dtype == r.y.dtype
    np.testing.assert_array_equal(p.X, r.X)
    np.testing.assert_array_equal(p.y, r.y)


@pytest.mark.parametrize("n,k,seed", [(270, 10, 0), (1000, 10, 0),
                                      (32561, 10, 0), (151, 7, 5)])
def test_kfold_chunks_bitwise(n, k, seed):
    np.testing.assert_array_equal(port_suite.kfold_chunks(n, k, seed=seed),
                                  ref_suite.kfold_chunks(n, k, seed=seed))


def test_specs_and_dataset_conversion():
    assert port_suite.SPECS == ref_suite.SPECS
    r = ref_suite.make_dataset("heart", n_override=40)
    p = dataset_from_reference(r)
    np.testing.assert_array_equal(p.X, r.X)
    np.testing.assert_array_equal(p.y, r.y)
    assert (p.name, p.C, p.gamma) == (r.name, r.C, r.gamma)


@pytest.mark.parametrize("vocab,batch,seq,seed,step", [
    (512, 2, 32, 0, 0), (49_152, 2, 4096, 0, 0), (256_000, 3, 18, 7, 5)])
def test_synthetic_token_batch_bitwise(vocab, batch, seq, seed, step):
    r = ref_tokens.synthetic_token_batch(vocab, batch, seq, seed=seed,
                                         step=step)
    p = port_tokens.synthetic_token_batch(vocab, batch, seq, seed=seed,
                                          step=step)
    assert p.keys() == r.keys()
    for key in r:
        assert p[key].dtype == r[key].dtype
        np.testing.assert_array_equal(p[key], r[key])
