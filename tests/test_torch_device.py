"""The port's device rule (`directdemod_tpu_torch.device.resolve`): every
entry point takes `device=None`, which is the current CUDA device and
raises without one; `device="cpu"` runs on the CPU. The raising half needs
a machine without a card and skips where there is one. A mesh
(`parallel.mesh.make_mesh`) follows the same rule: its shards are every
visible CUDA device for `device=None`, CPU shards for `device="cpu"`; the
sharded entry points run on the mesh's devices."""
import numpy as np
import pytest
import torch

from directdemod_tpu_torch import cli, device
from directdemod_tpu_torch.io.feeder import BlockFeeder
from directdemod_tpu_torch.io.sources import ArraySource
from directdemod_tpu_torch.models import doppler
from directdemod_tpu_torch.models.afsk1200 import Afsk1200Decoder
from directdemod_tpu_torch.models.fm import FmDecoder
from directdemod_tpu_torch.models.frontend import DdcFm, DdcFmStream
from directdemod_tpu_torch.models.funcube import FuncubeDecoder
from directdemod_tpu_torch.models.meteorm2 import MeteorM2Decoder
from directdemod_tpu_torch.models.multichannel import MultiDdcFm
from directdemod_tpu_torch.models.noaa import NoaaDecoder
from directdemod_tpu_torch.ops import design, pll
from directdemod_tpu_torch.parallel.dryrun import dryrun
from directdemod_tpu_torch.parallel.mesh import make_mesh, single_device_mesh
from directdemod_tpu_torch.stream import pipeline
from directdemod_tpu_torch.stream.api import Stream

FS = 2048000


def _src():
    return ArraySource(np.zeros(50_000, np.complex64), FS)


def _fe():
    return DdcFm(FS, 30000, design.blackmanharris(151), 60000)


# every entry point, called as a user would with the device left out
ENTRY_POINTS = {
    "NoaaDecoder": lambda **kw: NoaaDecoder(_src(), 30000, **kw),
    "Afsk1200Decoder": lambda **kw: Afsk1200Decoder(_src(), 12000, **kw),
    "FuncubeDecoder": lambda **kw: FuncubeDecoder(_src(), 5000, **kw),
    "MeteorM2Decoder": lambda **kw: MeteorM2Decoder(_src(), 4000, **kw),
    "FmDecoder": lambda **kw: FmDecoder(_src(), 30000, **kw),
    "DdcFm.process": lambda **kw: _fe().process(_src(), **kw),
    "MultiDdcFm.process": lambda **kw: MultiDdcFm(
        FS, (0, 30000), design.blackmanharris(151), 60000).process(_src(), **kw),
    "DdcFmStream": lambda **kw: DdcFmStream(_fe(), **kw),
    "BlockFeeder": lambda **kw: BlockFeeder(_src(), 10_000, **kw),
    "pll.initial_state": lambda **kw: pll.initial_state(
        FuncubeDecoder(_src(), 5000, device="cpu").p, 33, **kw),
    "doppler.find_shift": lambda **kw: doppler.find_shift(
        np.full(2 * 40_000, 127, np.uint8), FS, 145_900_000, 145_905_000, 20_000, **kw),
    "Stream": lambda **kw: Stream(_src(), **kw),
    "Pipeline": lambda **kw: pipeline.Pipeline([pipeline.FmDemod()], FS, **kw),
    "cli.main": lambda **kw: cli.main(["-f", "137620000", "-c", "137590000",
                                       "-d", "noaa", "missing.wav"], **kw),
    "make_mesh": lambda **kw: make_mesh(**kw),
    "make_mesh(time=2)": lambda **kw: make_mesh(time=2, **kw),
    "single_device_mesh": lambda **kw: single_device_mesh(**kw),
    "dryrun": lambda **kw: dryrun(2, chunk_len=4096, **kw),
}


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None resolves to it")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_a_card(no_card, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(set(ENTRY_POINTS) - {"cli.main"}))
def test_entry_point_runs_on_the_cpu_when_asked(name):
    ENTRY_POINTS[name](device="cpu")


def test_resolve():
    assert device.resolve("cpu") == torch.device("cpu")
    assert device.resolve(torch.device("cpu")) == torch.device("cpu")
    if torch.cuda.is_available():
        assert device.resolve(None) == device.resolve("cuda") == \
            torch.device("cuda", torch.cuda.current_device())
