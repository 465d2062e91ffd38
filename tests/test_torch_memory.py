"""The port's ``Vector`` (``znicz_tpu_torch.memory``) on its CPU device:
the cases of ``tests/test_memory.py``, each beside the reference's
``Vector`` on the same data, and the port's own rule: a host write
reaches the device tensor in place, keeping its address."""

import numpy as np
import pytest
import torch

from znicz_tpu.backends import XLADevice
from znicz_tpu.memory import Vector as RefVector
from znicz_tpu_torch.backends import CpuDevice, Device
from znicz_tpu_torch.memory import Vector


@pytest.fixture
def cpu():
    return Device.create("cpu")


def test_the_cpu_device(cpu):
    assert isinstance(cpu, CpuDevice) and cpu.type == "cpu"
    assert str(cpu) == "cpu" and cpu.compute_dtype == torch.float32
    assert cpu.precision_level == 0


def test_empty_vector_falsy():
    for v in (Vector(name="v"), RefVector(name="v")):
        assert not v
        with pytest.raises(ValueError):
            v.map_read()
        with pytest.raises(ValueError):
            v.unmap()


def test_upload_download(cpu):
    data = np.arange(4, dtype=np.float32)
    got = []
    for v, dev in ((Vector(data, name="v"), cpu),
                   (RefVector(data, name="v"), XLADevice())):
        v.initialize(dev)
        v.unmap()
        assert v.state_name == "DEVICE"
        assert tuple(v.devmem.shape) == (4,)
        with pytest.raises(ValueError):
            _ = v.mem
        v.map_read()
        got.append(np.array(v.mem))
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], [0, 1, 2, 3])


@pytest.mark.parametrize("invalidate", [False, True])
def test_host_write_uploads_on_unmap_in_place(cpu, invalidate):
    """``map_write`` (or ``map_invalidate``), a host write, ``unmap``:
    the device holds the write, in the same tensor (its ``data_ptr``)."""
    got = []
    for v, dev in ((Vector(np.zeros(3, np.float32), name="v"), cpu),
                   (RefVector(np.zeros(3, np.float32), name="v"),
                    XLADevice())):
        v.initialize(dev)
        v.unmap()
        ptr = v.devmem.data_ptr() if isinstance(v, Vector) else None
        v.map_invalidate() if invalidate else v.map_write()
        v.mem[...] = 7
        v.unmap()
        if ptr is not None:
            assert v.devmem.data_ptr() == ptr
        got.append(np.asarray(v.devmem))
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], [7, 7, 7])


def test_device_write_keeps_the_address(cpu):
    """A device result written through ``devmem`` lands in the resident
    tensor (cast to its dtype); only another shape binds a new one."""
    v = Vector(np.zeros((2, 2), np.float32), name="v")
    v.initialize(cpu)
    ptr = v.devmem.data_ptr()
    v.devmem = torch.full((2, 2), 3.0, dtype=torch.float64)
    assert v.devmem.data_ptr() == ptr and v.devmem.dtype == torch.float32
    assert v.state_name == "DEVICE"
    v.devmem = torch.ones(3)
    assert tuple(v.shape) == (3,)
    v.assign(np.full(3, 4.0, np.float32))  # a snapshot's value
    assert torch.equal(v.devmem, torch.full((3,), 4.0))


def test_device_access_while_host_dirty_raises(cpu):
    for v, dev in ((Vector(np.zeros(3, np.float32), name="v"), cpu),
                   (RefVector(np.zeros(3, np.float32), name="v"),
                    XLADevice())):
        v.initialize(dev)
        v.unmap()
        v.map_write()
        with pytest.raises(ValueError, match="unmap"):
            _ = v.devmem


def test_capture_guards():
    """A host sync inside a region's capture raises (the reference's
    tracing guard)."""
    v = Vector(np.zeros(3, dtype=np.float32), name="v")
    v._tracing = True
    for op in (v.map_read, v.unmap, v.map_invalidate):
        with pytest.raises(RuntimeError, match="region capture"):
            op()


def test_sample_size_and_len():
    for v in (Vector(np.zeros((8, 3, 2), np.float32), name="v"),
              RefVector(np.zeros((8, 3, 2), np.float32), name="v")):
        assert len(v) == 8 and v.sample_size == 6 and v.size == 48


def test_bf16_mirror_is_f32(cpu):
    v = Vector.adopt(torch.tensor([1.0, 2.5], dtype=torch.bfloat16))
    v.map_write()
    assert v.mem.dtype == np.float32
    v.mem[...] = [3.0, 1.0 / 3.0]
    v.unmap()
    assert v.devmem.dtype == torch.bfloat16
    assert torch.equal(v.devmem, torch.tensor([3.0, 1.0 / 3.0]).bfloat16())


def test_a_unit_snapshots_its_vectors_in_place(cpu):
    """``Unit.state_dict`` reads each owned Vector back to the host (a
    copy), ``load_state`` writes a value back into the same device
    tensor."""
    from znicz_tpu_torch.units import Unit

    unit = Unit(None, name="u")
    unit.table = Vector(np.arange(4, dtype=np.float32), name="u.table")
    unit.table.initialize(cpu)
    unit.table.devmem = torch.full((4,), 2.0)
    ptr = unit.table.devmem.data_ptr()
    state = unit.state_dict()
    np.testing.assert_array_equal(state["table"], [2, 2, 2, 2])
    state["table"][...] = 0  # a copy: the unit's tensor keeps its values
    assert torch.equal(unit.table.devmem, torch.full((4,), 2.0))
    unit.load_state({"table": np.full(4, 5.0, np.float32)})
    assert unit.table.devmem.data_ptr() == ptr
    assert torch.equal(unit.table.devmem, torch.full((4,), 5.0))
