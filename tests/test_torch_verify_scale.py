"""The port's verifier against the JAX package's on the scale scenarios
(``scale_1000``, ``scale_100k``, ``scale_1m``) and the annealed cells of
``optimized_vs_mst``: the same certificates, compared with ``==``.

Split from ``test_torch_verify.py`` so that no file takes much over 30 s
under ``--dist loadfile``: the million-node ring alone is ~5 s a package.
"""
import pytest

pytest.importorskip("torch")

from test_torch_verify import assert_same_certificates, case_id, cases  # noqa: E402


@pytest.mark.parametrize("case", cases(scale=True), ids=case_id)
def test_scale_certificates_equal_the_reference(case):
    assert_same_certificates(case)

