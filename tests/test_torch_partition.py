"""The port's ``MeshPartition`` against the JAX package's, method by method,
over the mesh shapes of ``tests/test_mesh_runtime.py`` — equal results and
equal error messages."""
import pytest

from repro.solvers import partition as jpart
from repro_torch import interop
from repro_torch.solvers import partition as tpart

SHAPES = [(1,), (4,), (2, 2), (4, 2), (1, 2), (2, 2, 2), (2, 1, 2)]
N = 8


def _raises_same(fn_j, fn_t):
    with pytest.raises(ValueError) as ej:
        fn_j()
    with pytest.raises(ValueError) as et:
        fn_t()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("shape", SHAPES)
def test_partition_matches_jax(shape):
    j, t = jpart.MeshPartition(N, shape), tpart.MeshPartition(N, shape)
    assert tpart.FACES == jpart.FACES
    assert (t.n, t.shape, t.ndim, t.p, t.full_shape, t.block) == \
        (j.n, j.shape, j.ndim, j.p, j.full_shape, j.block)
    for i in range(j.p):
        assert t.coords(i) == j.coords(i)
        assert t.rank(*t.coords(i)) == j.rank(*j.coords(i)) == i
        assert t.offsets(i) == j.offsets(i)
        assert t.block_spec(i) == j.block_spec(i)
        assert t.neighbors(i) == j.neighbors(i)
        for k in range(j.p):
            if k in j.neighbors(i):
                assert t.face(i, k) == j.face(i, k)
            else:
                _raises_same(lambda: j.face(i, k), lambda: t.face(i, k))
    assert t.face_shapes() == j.face_shapes()
    for delay in (0, 1, 3):
        assert t.ring_slots(delay) == j.ring_slots(delay)
        assert t.buffer_elems(delay) == j.buffer_elems(delay)
    assert t.buffer_elems() == j.buffer_elems()
    assert interop.partition_from(j) == t
    for bad in ((-1,), (j.p,)):
        _raises_same(lambda: j.coords(*bad), lambda: t.coords(*bad))
    _raises_same(lambda: j.rank(*([0] * (j.ndim + 1))),
                 lambda: t.rank(*([0] * (t.ndim + 1))))
    _raises_same(lambda: j.rank(*j.shape), lambda: t.rank(*t.shape))
    _raises_same(lambda: j.ring_slots(-1), lambda: t.ring_slots(-1))


@pytest.mark.parametrize("n,shape", [(8, (2, 2, 2, 2)), (8, (2, 0)), (9, (2,)),
                                     (8, ()), (10, (2, 4))])
def test_partition_validation_matches_jax(n, shape):
    _raises_same(lambda: jpart.MeshPartition(n, shape),
                 lambda: tpart.MeshPartition(n, shape))
