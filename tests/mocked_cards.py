"""Mocked cards for the CPU tests: tensors that say they lie on a card.

The dispatchers of ``plotweave_torch`` pick a kernel's wrapper by
``tensor.is_cuda``.  A :class:`CardTensor` is a host tensor whose
``is_cuda`` is true and whose ``device`` is the mocked card it was put on
(``cuda:0`` unless said otherwise), so a program given one takes its card
route, and slabs on different mocked cards really differ in ``device``;
:func:`on_mocked_cards` patches the wrappers that the sharded programs reach
into recorders that run the plain versions on the host.  Any other torch op
on a CardTensor fails the test, so a test that passes shows that the card
route runs kernels and copies only.  Inside :class:`cards`, allocations and
uploads asked of a CUDA device land on the host as CardTensors on that
device.
"""

from __future__ import annotations

import importlib

import pytest
import torch
from torch.overrides import TorchFunctionMode

CPU = torch.device("cpu")
CARD0 = torch.device("cuda", 0)
# (destination, source) devices of each copy_ between two mocked devices: a peer copy on cards
PEER_COPIES: list = []


def _card_device(d):
    """The CUDA device ``d`` names (index 0 where it names none), else None."""
    if not isinstance(d, (torch.device, str)):
        return None
    d = torch.device(d)
    return torch.device("cuda", d.index or 0) if d.type == "cuda" else None


class CardTensor(torch.Tensor):
    """A host tensor that says it lies on a card (``card``, its device).
    The dispatchers send it to the kernels' wrappers (patched by
    :func:`on_mocked_cards` to record each call and run the plain version),
    and any torch op on it but a view, a shape, an allocation or a copy
    fails the test: no plain op runs on the card.  Allocations asked of a
    CUDA device land on the host, on that mocked card."""

    ALLOWED = {"__get__", "__getitem__", "__len__", "new_empty", "view", "reshape", "size", "dim", "stride",
               "numel", "element_size", "data_ptr", "is_contiguous", "tensor_split", "cpu", "copy_", "contiguous",
               "as_subclass"}
    mock_device = CARD0

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return self.mock_device

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        name = getattr(func, "__name__", str(func))
        if name not in cls.ALLOWED:
            raise AssertionError(f"a plain op on a card tensor: {name}")
        dev = _card_device(kwargs.get("device"))
        if dev is not None:
            kwargs["device"] = CPU
        else:
            dev = next((a.mock_device for a in args if isinstance(a, CardTensor)), CARD0)
        if name == "copy_" and isinstance(args[1], torch.Tensor) and args[0].device != args[1].device:
            PEER_COPIES.append((args[0].device, args[1].device))
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **kwargs)
        if name == "cpu":
            return plain(out)
        return card(out, dev)


class cards(TorchFunctionMode):
    """While entered, a torch call that allocates on a CUDA device
    (``device=`` a card) or uploads a host tensor to one (``.to(card)``)
    runs on the host and returns CardTensors on that mocked card."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        dev = _card_device(kwargs.get("device"))
        if dev is not None:
            kwargs["device"] = CPU
        elif getattr(func, "__name__", "") == "to" and args and not isinstance(args[0], CardTensor):
            dev = next((d for d in map(_card_device, args[1:]) if d is not None), None)
            if dev is not None:
                args = (args[0], *[a for a in args[1:] if _card_device(a) is None])
        out = func(*args, **kwargs)
        return out if dev is None else card(out, dev)


def card(x, device=None):
    """Tensors (in tuples and lists too) as CardTensors sharing storage, on
    ``device`` where given (a CardTensor keeps its own otherwise)."""
    if isinstance(x, (tuple, list)):
        return type(x)(card(t, device) for t in x)
    if isinstance(x, torch.Tensor):
        if not isinstance(x, CardTensor):
            with torch._C.DisableTorchFunctionSubclass():
                x = x.as_subclass(CardTensor)
        if device is not None:
            x.mock_device = device
    return x


def plain(x):
    if isinstance(x, (tuple, list)):
        return type(x)(plain(t) for t in x)
    if isinstance(x, torch.Tensor):
        with torch._C.DisableTorchFunctionSubclass():
            return x.as_subclass(torch.Tensor)
    return x


def on_mocked_cards(monkeypatch) -> list:
    """Patch every kernel wrapper that the sharded programs reach into a
    recorder that runs the plain version on the host, its outputs on the
    mocked card of its card tensors (tensors on two cards fail); returns the list of the wrappers'
    names, one entry a launch."""
    canny, filters, frontend, kernels, morphology, thinning = (
        importlib.import_module(f"plotweave_torch.ops.{m}")
        for m in ("canny", "filters", "frontend", "kernels", "morphology", "thinning"))
    calls = []

    def fake(name, fn):
        def run(*args, **kwargs):
            calls.append(name)
            on = {a.mock_device for a in (*args, *kwargs.values()) if isinstance(a, CardTensor)}
            if len(on) > 1:  # a kernel reads and writes one card's memory
                pytest.fail(f"{name} given tensors on {sorted(map(str, on))}")
            return card(fn(*plain(list(args)), **{k: plain(v) for k, v in kwargs.items()}), next(iter(on), None))

        monkeypatch.setattr(kernels, name, run)

    fake("morph_steps_cuda", morphology.morph_steps_plain)
    fake("morph_dense_cuda", morphology.morph_dense_plain)
    fake("edge_candidates_slab_cuda", canny.edge_candidates_slab_plain)
    fake("gaussian_blur_slab_cuda", filters.gaussian_blur_slab_plain)
    fake("hysteresis_slab_cuda", canny.hysteresis_slab_plain)
    fake("zhang_suen_slab_cuda", thinning.zhang_suen_slab_plain)
    fake("assign_boards_cuda", lambda img, c, counts=None: frontend.assign_boards_plain(img, c, c.shape[0]))
    fake("dense_to_boards_cuda", thinning.pack_bitboards_plain)
    fake("boards_to_dense_cuda", lambda b, w, value=1, dtype=torch.uint8, out=None:
         thinning.unpack_bitboards_plain(b, w).to(dtype) * value)
    for name in ("edge_candidates_cuda", "hysteresis_cuda", "zhang_suen_packed_cuda", "zhang_suen_into_cuda",
                 "gaussian_blur_cuda", "rows_to_boards_cuda", "boards_to_rows_cuda", "labels_to_boards_cuda",
                 "assign_nearest_cuda", "zhang_suen_dense_cuda"):  # the unsharded programs' kernels: not here
        monkeypatch.setattr(kernels, name, lambda *a, name=name, **k: pytest.fail(f"{name} on a sharded route"))
    return calls


def launches(calls: list) -> dict:
    return {name: calls.count(name) for name in sorted(set(calls))}


def stage02_on_cards(monkeypatch, n_cards: int) -> tuple:
    """Stage 02 over ``n_cards`` mocked cards (``tests/mocked_cards.py``):
    the card count and ``torch.cuda.is_available`` patched, the kernels'
    wrappers recording and running the plain versions, and the stage's
    ``sharded_chain`` given the masks as a card tensor.  The unsharded chain
    fails the test.  Returns (the wrappers' calls, the meshes' space
    devices a call)."""
    from plotweave_torch.stages import s02_color_extract as s02

    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls, meshes = on_mocked_cards(monkeypatch), []
    real = s02.sharded_chain

    def on_cards(mesh, packed, w, *params):  # in the stage's own thread: the mode is entered there
        meshes.append(mesh.along("space"))
        with cards():
            return plain(real(mesh, card(torch.from_numpy(packed), mesh.along("space")[0]), w, *params))

    monkeypatch.setattr(s02, "sharded_chain", on_cards)
    monkeypatch.setattr(s02, "chain_from_clean", lambda *a, **k: pytest.fail("the unsharded chain ran"))
    return calls, meshes
