"""Graph captures from several serving threads (``runtime/graphs.py``).

A serving process captures its programs at first use, in whichever thread
needs them: the continuous engine's decode thread its blocks and
admission prefills, a connection's thread a vocoder window. Entering
``torch.cuda.graph`` synchronizes the device and empties the caching
allocator and the pinned host cache; done while another thread captures,
that invalidates the other capture (on an H100 the soak's cold server lost
its decode loop so: "operation not permitted when stream is capturing",
then "operation failed due to a previous error during capture"). So a
process warms up and captures one program at a time.

On the CPU the test drives ``GraphCache.capture`` from several threads
over a stand-in for ``torch.cuda``'s graph API that records whether a
capture began, or the device was synchronized, while another thread's
capture was open. On a card (``-m cuda``; skipped here) two caches
capture from two threads at once and each program replays its own
body's result.
"""

import contextlib
import threading
import time

import pytest
import torch

from rwkv_tts_tpu_torch.runtime import graphs


class FakeStream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


class GraphApi:
    """``torch.cuda``'s graph entry points as ``GraphCache`` calls them,
    recording overlap: ``overlaps`` counts captures begun (each begins by
    synchronizing the device) while another thread's was open."""

    def __init__(self, hold_s=0.05):
        self.hold_s = hold_s
        self.lock = threading.Lock()
        self.open = 0
        self.overlaps = 0
        self.captures = 0

    @contextlib.contextmanager
    def graph(self, g, pool=None, stream=None, capture_error_mode=None):
        with self.lock:
            self.overlaps += self.open > 0
            self.open += 1
            self.captures += 1
        try:
            time.sleep(self.hold_s)
            yield
        finally:
            with self.lock:
                self.open -= 1

    def install(self, mp):
        mp.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
        mp.setattr(torch.cuda, "Stream", lambda device=None: FakeStream())
        mp.setattr(torch.cuda, "stream",
                   lambda s: contextlib.nullcontext())
        mp.setattr(torch.cuda, "current_stream",
                   lambda device=None: FakeStream())
        mp.setattr(torch.cuda, "CUDAGraph", object)
        mp.setattr(torch.cuda, "graph", self.graph)
        mp.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)


@pytest.fixture()
def api(monkeypatch):
    a = GraphApi()
    a.install(monkeypatch)
    return a


def test_captures_from_threads_take_turns(api):
    """Six threads, each capturing two programs into caches of its own at
    the same moment: no capture begins while another is open."""
    start = threading.Barrier(6)
    errors = []

    def serve(i):
        try:
            cache = graphs.GraphCache("cuda:0")
            start.wait(timeout=30)
            for key in range(2):
                cache.program(key, lambda bufs: time.sleep(0.005),
                              {"x": torch.zeros(2)})
        except Exception as e:  # noqa: BLE001: reported below
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert api.captures == 12
    assert api.overlaps == 0


def test_capture_reports_its_wait(api):
    """A program's stats carry the wait for the capture turn beside the
    warm-up, capture and instantiate seconds."""
    cache = graphs.GraphCache("cuda:0")
    prog = cache.program("k", lambda bufs: None, {"x": torch.zeros(1)})
    assert set(prog.stats) == {"wait_s", "warmup_s", "capture_s",
                               "instantiate_s", "pool_bytes"}
    assert prog.stats["wait_s"] >= 0.0


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_concurrent_captures_on_card(cuda_card):
    """Two caches capture at once from two threads, each body a chain of
    products on its own buffers, while a third thread launches work: both
    programs replay their bodies' results."""
    dev = torch.device("cuda", torch.cuda.current_device())
    start = threading.Barrier(3)
    out, errors = {}, []
    stop = threading.Event()

    def body(bufs):
        y = bufs["x"]
        for _ in range(20):
            y = torch.tanh(y @ bufs["w"])
        bufs["y"].copy_(y)

    def capture(i):
        try:
            gen = torch.Generator(device=dev).manual_seed(i)
            bufs = {"x": torch.randn((64, 256), generator=gen, device=dev),
                    "w": torch.randn((256, 256), generator=gen,
                                     device=dev) / 16,
                    "y": torch.empty((64, 256), device=dev)}
            cache = graphs.GraphCache(dev)
            start.wait(timeout=30)
            prog = cache.program("k", body, bufs)
            prog.replay()
            torch.cuda.current_stream(dev).synchronize()
            want = {k: v.clone() for k, v in bufs.items()}
            body(want)
            out[i] = torch.equal(bufs["y"], want["y"])
        except Exception as e:  # noqa: BLE001: reported below
            errors.append(e)

    def busy():
        a = torch.randn((512, 512), device=dev)
        start.wait(timeout=30)
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            while not stop.is_set():
                a = torch.tanh(a @ a / 512)
        torch.cuda.synchronize(dev)

    threads = [threading.Thread(target=capture, args=(i,)) for i in (0, 1)]
    other = threading.Thread(target=busy)
    for t in threads + [other]:
        t.start()
    for t in threads:
        t.join(timeout=120)
    stop.set()
    other.join(timeout=60)
    assert not errors, errors
    assert out == {0: True, 1: True}
