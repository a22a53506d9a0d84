"""The reduction of a profiler trace to busy time, idle gaps and device
operations, on a hand-made list of events: overlapping operations count
once, the lead-in's operations and the device side of the benchmark's own
spans are left out, and each gap is named by the host span open when it
began."""
import pytest

torch = pytest.importorskip("torch")

import perfbench_tiny  # noqa: E402,F401  (puts the benchmark on sys.path)

import devtrace as tr  # noqa: E402


class _Event:
    def __init__(self, name, on_device, start, end):
        self.args = (name, on_device, start, end)

    def name(self):
        return self.args[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.args[1] else DeviceType.CPU

    def start_ns(self):
        return self.args[2]

    def end_ns(self):
        return self.args[3]


class _Profile:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda _self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def test_read_a_stretch():
    events = [_Event("flash_kernel_ws", True, 0, 50),  # the lead-in's
              _Event(tr.STRETCH, False, 100, 1000), _Event(tr.STRETCH, True, 100, 1000),
              _Event("bench.prefill", False, 100, 600),
              _Event("flash_kernel_ws", True, 150, 300), _Event("gemm", True, 250, 500),
              _Event("gemm", True, 700, 900)]
    st = tr.read(_Profile(events), tr.Stretch())
    assert st.window_s == pytest.approx(900e-9)
    assert st.busy_s == pytest.approx(550e-9)  # 150-500 and 700-900
    assert st.device_ops == {"flash_kernel_ws": [1, pytest.approx(150e-9)],
                             "gemm": [2, pytest.approx(450e-9)]}
    assert [n for n, _ in st.gaps] == ["bench.prefill", "none", "bench.prefill"]
    assert [g for _, g in st.gaps] == pytest.approx([200e-9, 100e-9, 50e-9])
    assert tr.breakdown(st)["idle_gaps"][0] == ["bench.prefill", pytest.approx(200e-9)]


def test_union():
    assert tr.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


def _run_of(kind, chips=1, **stretch):
    import harness

    cfg = {"family": "dense"}
    return harness.Run(kind=kind, config=cfg, traffic={}, chips=chips,
                       stretch=tr.Stretch(**stretch))


def test_collective_ms_reads_the_nccl_kernels_a_step():
    import harness

    read = harness.load_reader("collective_ms.train_tp")
    ops = {"ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage<4096ul>)": [6, 0.09],
           "nccl:all_reduce": [6, 0.1],
           "ncclDevKernel_AllGather_RING_LL": [2, 0.03], "nvjet_tst_128x256": [90, 1.0]}
    assert read(_run_of("train_tp", steps=2, device_ops=ops)) == pytest.approx(60.0)
    assert read(_run_of("train_tp", steps=2, device_ops={"nvjet": [1, 1.0]})) is None
    assert read(_run_of("train", steps=2, device_ops=ops)) is None
    assert read(_run_of("train_tp", steps=0, device_ops=ops)) is None


@pytest.mark.parametrize("name,kind", [("mfu.train", "train"), ("mfu.train_tp", "train_tp"),
                                       ("mfu.prefill", "prefill")])
def test_mfu_is_a_share_of_every_chips_peak(name, kind, monkeypatch):
    import flops
    import harness

    read = harness.load_reader(name)
    monkeypatch.setattr(flops, "prefill_flops" if kind == "prefill" else "train_step_flops",
                        lambda cfg, B, S: 989e12)
    run = _run_of(kind, steps=1, seconds=1.0, busy_s=0.5)
    run.traffic = {"batch": 1, "seq_len": 1}
    assert read(run) == pytest.approx(100.0)
    run.chips = 4
    assert read(run) == pytest.approx(25.0)
    run.kind = "other"
    assert read(run) is None


@pytest.mark.parametrize("name,kind", [("idle_share.train", "train"),
                                       ("idle_share.train_tp", "train_tp"),
                                       ("idle_share.prefill", "prefill")])
def test_idle_share_of_its_own_kind(name, kind):
    import harness

    read = harness.load_reader(name)
    assert read(_run_of(kind, steps=1, window_s=2.0, busy_s=1.5)) == pytest.approx(25.0)
    assert read(_run_of("other", steps=1, window_s=2.0, busy_s=1.5)) is None
    assert read(_run_of(kind, steps=1, window_s=2.0, busy_s=0.0)) is None


def test_collectives_annotations_are_no_device_operation():
    events = [_Event(tr.STRETCH, False, 100, 1000), _Event("nccl:all_reduce", True, 150, 900),
              _Event("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", True, 400, 500)]
    st = tr.read(_Profile(events), tr.Stretch())
    assert list(st.device_ops) == ["ncclDevKernel_AllReduce_Sum_bf16_RING_LL"]
    assert st.busy_s == pytest.approx(100e-9)
