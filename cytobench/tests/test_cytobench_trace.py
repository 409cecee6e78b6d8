"""The trace reader's arithmetic on events made by hand (no card here), and
the encoder's marks on a CPU profile."""

import importlib.util
from types import SimpleNamespace

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cytobench import flops, trace

from . import tiny


def _ev(name, start, end, dev=DeviceType.CPU, id=0, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=dev, id=id, thread=thread, is_user_annotation=False)


def _events():
    cuda = DeviceType.CUDA
    return [
        _ev(trace.WINDOW, 0, 100),
        _ev(trace.ENCODER, 5, 30, id=50),
        _ev("cudaLaunchKernel", 6, 7, id=101),  # runtime calls in the range
        _ev("cuLaunchKernelEx", 8, 9, id=103),
        _ev("aten::add", 10, 11, id=102),  # an operator's id is no launch's
        _ev("cudaLaunchKernel", 40, 41, id=102),  # outside the range
        _ev("cudaLaunchKernel", 6, 7, id=104, thread=2),  # another thread
        _ev("gemm_bf16", 10, 20, cuda, id=101),
        _ev("ln_rows", 15, 30, cuda, id=103),
        _ev("add_kernel", 45, 60, cuda, id=102),
        _ev("other", 70, 80, cuda, id=104),
        _ev(trace.ENCODER, 10, 30, cuda, id=50),  # the mark on the device's timeline
    ]


def test_encoder_time_is_the_union_of_its_kernels():
    p = trace.read(_events())
    assert p["encoder_s"] == [20e-6]  # [10, 20] and [15, 30] merge to 20 us
    assert abs(p["busy_s"] - (20 + 15 + 10) * 1e-6) < 1e-12
    assert p["window_s"] == 100e-6


def test_encoder_roofline_reads_least_time_over_device_time():
    spec = importlib.util.spec_from_file_location(
        "enc_roof", tiny.HERE / "metrics" / "encoder_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = tiny.tiny_config()
    least = flops.encoder_least_s(cfg, 4)
    rec = {"config": cfg, "profile": {"encoder_s": [4 * least, 2 * least]},
           "encoder_images": [4, 4]}
    assert abs(mod.read(rec) - 100.0 / 3) < 1e-9
    assert mod.read(dict(rec, encoder_images=[4])) is None  # a call the trace lacks
    assert mod.read({"config": cfg, "profile": {}}) is None


class SamImageEncoder(torch.nn.Module):
    def forward(self, x):
        return x * 2


def test_encoder_calls_are_marked_in_the_profile():
    enc, images = SamImageEncoder(), []
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            trace.mark_encoder(images, "SamImageEncoder"):
        enc(torch.ones(3, 2))
        enc(torch.ones(5, 2))
        torch.nn.Linear(2, 2)(torch.ones(1, 2))
    assert images == [3, 5]
    assert sum(e.name == trace.ENCODER for e in prof.events()) == 2
    enc(torch.ones(7, 2))  # the hooks are gone after the block
    assert images == [3, 5]
