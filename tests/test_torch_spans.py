"""The port's profiler spans on the CPU (``utils.summary.span``): where the
image tower, the attention core and the train step open them, how many
each records, that none nests in a range of its own name, that with no
profiler a span is the shared null context and enters no range, and that
a profiler running changes no output bit.

The tiny MS-CLIP-S geometry of ``reference_oracle.tiny_msclips_config``
with 6 layers: the stem, the branch stages and lateral adapters at layers
2 and 4, the trunk blocks and the shared text blocks all run.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msclip_torch.data.pairs import SyntheticPairDataset
from msclip_torch.models import msclip as TM
from msclip_torch.train import trainer as TT
from msclip_torch.utils import summary

from reference_oracle import tiny_msclips_config
from torch_threads import one_torch_thread  # noqa: F401

SPANS = ("msclip.image.stem", "msclip.image.branch", "msclip.image.block",
         "msclip.attention.fwd", "msclip.attention.bwd",
         "msclip.train.forward", "msclip.train.backward",
         "msclip.train.optimizer")


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_msclips_config(layers=6)
    spec = TM.spec_from_config(cfg)
    params = TM.init_params(spec, torch.Generator().manual_seed(0))
    blocks = range(spec.first_block, spec.effective_vision_layers)
    geometry = {"blocks": len(blocks),
                "laterals": sum(i in spec.lateral_layers for i in blocks),
                "text_blocks": spec.text_layers}
    assert geometry["laterals"] == 2 and geometry["blocks"] >= 5
    return cfg, spec, params, geometry


def _batch(b=4, seed=7):
    ds = SyntheticPairDataset(n=b, size=64, vocab_size=512, seed=seed)
    images, tokens = zip(*(ds[i] for i in range(b)))
    return (torch.from_numpy(np.stack(images)),
            torch.from_numpy(np.stack(tokens)))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.events() if e.name in SPANS]
    counts = {name: sum(e.name == name for e in events) for name in SPANS}
    return out, events, counts


def _encode(params, spec, images):
    with torch.no_grad():
        return TM.encode_image(params, spec, images)


def _step(cfg, spec, params, accum_steps=1, seed=11):
    state = TT.init_train_state(cfg, spec, {k: v.clone()
                                            for k, v in params.items()},
                                10, "cpu")
    step = TT.make_train_step(spec, accum_steps=accum_steps)
    return lambda: step(state, *_batch(seed=seed))["loss"]


def test_encode_image_opens_each_span_once_a_module(tiny):
    _, spec, params, g = tiny
    images, _ = _batch()
    _, _, counts = _traced(lambda: _encode(params, spec, images))
    assert counts == {**dict.fromkeys(SPANS, 0),
                      "msclip.image.stem": 1,
                      "msclip.image.branch": g["laterals"],
                      "msclip.image.block": g["blocks"],
                      "msclip.attention.fwd": g["blocks"]}


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_a_train_step_opens_each_phase_once(tiny, accum_steps):
    """Forward, backward and optimizer once a step, GradCache's two passes
    included; the attention backward once a block of either tower and
    microbatch, and the forward once more a microbatch for GradCache's
    second pass."""
    cfg, spec, params, g = tiny
    _, _, counts = _traced(_step(cfg, spec, params, accum_steps))
    towers = g["blocks"] + g["text_blocks"]
    passes = 1 if accum_steps == 1 else 2 * accum_steps
    assert counts == {"msclip.image.stem": passes,
                      "msclip.image.branch": passes * g["laterals"],
                      "msclip.image.block": passes * g["blocks"],
                      "msclip.attention.fwd": passes * towers,
                      "msclip.attention.bwd": max(1, passes // 2) * towers,
                      "msclip.train.forward": 1,
                      "msclip.train.backward": 1,
                      "msclip.train.optimizer": 1}


def test_the_train_phases_follow_one_another(tiny):
    cfg, spec, params, _ = tiny
    _, events, _ = _traced(_step(cfg, spec, params))
    phase = {e.name: e.time_range for e in events
             if e.name.startswith("msclip.train.")}
    assert phase["msclip.train.forward"].end \
        <= phase["msclip.train.backward"].start
    assert phase["msclip.train.backward"].end \
        <= phase["msclip.train.optimizer"].start


def test_no_span_nests_in_a_range_of_its_own_name(tiny):
    """``key_averages`` would count such a span twice. The spans are
    function ranges, not user annotations: the profiler gives an
    annotation a device twin that would fill the device's idle gaps."""
    cfg, spec, params, _ = tiny
    _, events, counts = _traced(_step(cfg, spec, params, accum_steps=2))
    assert all(counts.values())
    for e in events:
        assert not e.is_user_annotation, e.name
        parent = e.cpu_parent
        while parent is not None:
            assert parent.name != e.name, e.name
            parent = parent.cpu_parent


def test_without_a_profiler_a_span_is_the_shared_null_context(
        tiny, monkeypatch):
    """No ``msclip.`` range is entered by either route (torch's own
    optimizer opens its ranges whatever runs)."""
    cfg, spec, params, _ = tiny

    def refusing(enter):
        def guarded(name, *args, **kwargs):
            if name.startswith("msclip."):
                raise AssertionError(f"{name} entered with no profiler")
            return enter(name, *args, **kwargs)
        return guarded

    for module in (torch.autograd.profiler, torch.profiler):
        monkeypatch.setattr(module, "record_function",
                            refusing(module.record_function))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        refusing(torch._C._profiler._RecordFunctionFast))
    assert not torch.autograd._profiler_enabled()
    assert summary.span("msclip.image.stem") is summary.span("other")
    with summary.span("msclip.image.stem") as entered:
        assert entered is None
    images, _ = _batch()
    _encode(params, spec, images)
    _step(cfg, spec, params)()


def test_a_profiler_changes_no_output_bit(tiny):
    cfg, spec, params, _ = tiny
    images, _ = _batch()
    plain = _encode(params, spec, images)
    traced, _, _ = _traced(lambda: _encode(params, spec, images))
    assert torch.equal(plain, traced)
    loss = _step(cfg, spec, params)()
    traced, _, _ = _traced(_step(cfg, spec, params))
    assert torch.equal(loss, traced)
