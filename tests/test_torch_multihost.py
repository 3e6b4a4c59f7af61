"""mccnn_tpu_torch.parallel.multihost: the scene assignment against the
JAX package's, its defaults, and the process group it starts."""

import pytest

torch = pytest.importorskip("torch")

from mccnn_tpu.parallel import multihost as jhost  # noqa: E402
from mccnn_tpu_torch.parallel import multihost as thost  # noqa: E402


@pytest.mark.parametrize("count", [1, 2, 3, 5, 8])
def test_assignment_equals_jax_over_a_grid(count):
    """Every (scenes, rank, count): the same indices and pairs, and the
    ranks together own each scene exactly once."""
    for num in range(0, 13):
        owned = []
        for rank in range(count):
            got = thost.process_slice(num, rank, count)
            assert got == jhost.process_slice(num, rank, count)
            names = [f"s{i}" for i in range(num)]
            assert thost.shard_scenes(names, rank, count) == \
                jhost.shard_scenes(names, rank, count)
            owned += got
        assert sorted(owned) == list(range(num))


def test_defaults_read_the_environment(monkeypatch):
    """No process group: ``RANK`` / ``WORLD_SIZE``, else one process, as
    ``jax.process_index()`` / ``jax.process_count()`` say for one."""
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert thost.process_slice(5) == jhost.process_slice(5) == [0, 1, 2, 3,
                                                                  4]
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert thost.process_slice(8) == [1, 4, 7]
    assert thost.shard_scenes(["a", "b", "c"]) == [(1, "b")]


def test_defaults_read_the_process_group(monkeypatch):
    """A started group's rank and size win over the environment."""
    import torch.distributed as dist

    from mccnn_tpu_torch.parallel.launch import free_port
    from mccnn_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    thost.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                 device="cpu", timeout_s=30)
    try:
        assert thost.process_slice(3) == [0, 1, 2]
        mesh = make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        assert mesh.shape == {"data": 1}
        with pytest.raises(ValueError, match="only 1 available"):
            make_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="1-D"):
            make_mesh(axis_names=("data", "disp"), shape=(1, 2),
                      device="cpu")
        with pytest.raises(ValueError, match="runs 'gloo'"):
            make_mesh(device="cpu", backend="nccl")
    finally:
        dist.destroy_process_group()


def test_coordinator_needs_the_process_count():
    with pytest.raises(ValueError, match="num_processes"):
        thost.initialize_distributed("127.0.0.1:1234", device="cpu")


def test_nccl_refuses_two_ranks_on_one_card():
    """NCCL takes one rank per card; the message names gloo."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match='backend="gloo"'):
        thost.check_nccl_ranks("nccl", cards + 1)
    thost.check_nccl_ranks("gloo", cards + 1)
