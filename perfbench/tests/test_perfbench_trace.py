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
