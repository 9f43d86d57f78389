"""The port's prompt expander and Qwen-VL helpers (`utils/prompt_extend.py`,
`utils/qwen_vl.py`, copies of the JAX package's JAX-free modules) against
the JAX package's, on the offline cases of tests/test_utils.py and
tests/test_qwen_vl.py: the template expander (the offline fallback), the
zh / en x text / VL system prompts, DashScope without a key, smart_resize,
smart_nframes, fetch_image and the vision-info walk. DashScope needs the
network and is not run; the local Qwen expander runs on stand-ins for the
`transformers` classes (no checkpoint here), which check that the model and
its inputs sit on the expander's device."""
import base64
import io
import sys
import types

import numpy as np
import pytest
import torch

from realtime_video_tpu.utils import prompt_extend as jpe
from realtime_video_tpu.utils import qwen_vl as jqv
from realtime_video_tpu_torch.utils import prompt_extend as tpe
from realtime_video_tpu_torch.utils import qwen_vl as tqv


def test_system_prompts_are_jaxs():
    for name in ("LM_EN_SYS_PROMPT", "LM_ZH_SYS_PROMPT", "VL_EN_SYS_PROMPT",
                 "VL_ZH_SYS_PROMPT"):
        assert getattr(tpe, name) == getattr(jpe, name)


@pytest.mark.parametrize("seed", [-1, 0, 3, 11])
def test_template_expander_matches_jax(seed, monkeypatch):
    monkeypatch.delenv("DASH_API_KEY", raising=False)
    exp = tpe.get_prompt_expander("auto")
    assert isinstance(exp, tpe.TemplatePromptExpander)
    out = exp("a cat", seed=seed)
    assert out.status and out.prompt.startswith("a cat, ")
    assert tpe.TemplatePromptExpander._SUFFIXES == jpe.TemplatePromptExpander._SUFFIXES
    if seed < 0:  # a negative seed draws a fresh one on both sides
        assert out.prompt[len("a cat, "):] in tpe.TemplatePromptExpander._SUFFIXES
        return
    assert out.prompt == jpe.get_prompt_expander("auto")("a cat", seed=seed).prompt
    assert exp("a cat", seed=seed).prompt == out.prompt  # deterministic per seed


def test_system_prompt_selection_matches_jax():
    for is_vl in (False, True):
        t = tpe.get_prompt_expander("template", is_vl=is_vl)
        j = jpe.get_prompt_expander("template", is_vl=is_vl)
        for lang in ("en", "zh", "ch"):
            assert t.decide_system_prompt(lang) == j.decide_system_prompt(lang)
    vl = tpe.get_prompt_expander("template", is_vl=True)
    assert vl.decide_system_prompt("en") == tpe.VL_EN_SYS_PROMPT
    out = vl("a cat", tar_lang="en", image=object(), seed=5)
    want = jpe.get_prompt_expander("template", is_vl=True)("a cat", tar_lang="en",
                                                           image=object(), seed=5)
    assert out.status and out.system_prompt == tpe.VL_EN_SYS_PROMPT
    assert out.prompt == want.prompt
    out.add_custom_field("model", "x")
    assert out.model == "x"


def test_dashscope_without_key_degrades(monkeypatch):
    monkeypatch.delenv("DASH_API_KEY", raising=False)
    for is_vl, kw in ((False, {}), (True, {"image": object()})):
        out = tpe.get_prompt_expander("dashscope", is_vl=is_vl)("a dog", seed=1, **kw)
        assert not out.status and out.prompt == "a dog" and "DASH_API_KEY" in out.message


def test_smart_resize_and_nframes_match_jax():
    for h, w in [(480, 832), (1080, 1920), (28, 28), (3000, 4000), (50, 70)]:
        nh, nw = tqv.smart_resize(h, w)
        assert (nh, nw) == jqv.smart_resize(h, w)
        assert nh % tqv.IMAGE_FACTOR == 0 and nw % tqv.IMAGE_FACTOR == 0
        assert tqv.MIN_PIXELS <= nh * nw <= tqv.MAX_PIXELS
    with pytest.raises(ValueError):
        tqv.smart_resize(10, 4000)
    for ele, total, fps in (({"nframes": 7}, 100, 30), ({}, 100, 30.0), ({"fps": 4}, 300, 24)):
        assert tqv.smart_nframes(ele, total, fps) == jqv.smart_nframes(ele, total, fps)
    assert tqv.smart_nframes({"nframes": 7}, total_frames=100, video_fps=30) == 8
    with pytest.raises(ValueError):
        tqv.smart_nframes({"nframes": 4, "fps": 2}, total_frames=10, video_fps=30)


def test_fetch_image_and_vision_info_match_jax(tmp_path):
    from PIL import Image

    arr = np.random.default_rng(63).integers(0, 255, (50, 70, 3), np.uint8)
    path = tmp_path / "img.png"
    Image.fromarray(arr).save(path)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    data_uri = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    for ele in ({"image": str(path)}, {"image": f"file://{path}"}, {"image": data_uri},
                {"image": arr, "resized_height": 60, "resized_width": 90}):
        got, want = tqv.fetch_image(ele), jqv.fetch_image(ele)
        assert got.size == want.size and got.height % tqv.IMAGE_FACTOR == 0
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="network"):
        tqv.fetch_image({"image": "https://example.invalid/a.png"})
    conv = [{"role": "user", "content": [{"type": "image", "image": str(path)},
                                         {"type": "text", "text": "describe"},
                                         {"video": "b.mp4"}]}]
    assert tqv.extract_vision_info(conv) == jqv.extract_vision_info(conv)
    images, videos = tqv.process_vision_info([{"role": "user", "content": [
        {"image": data_uri}, {"type": "text", "text": "x"}]}])
    assert videos is None and len(images) == 1
    np.testing.assert_array_equal(np.asarray(images[0]),
                                  np.asarray(jqv.fetch_image({"image": data_uri})))


class _Batch(dict):
    """A tokenizer's / processor's output: tensors with `.to(device)`."""

    def to(self, device):
        return _Batch({k: v.to(device) for k, v in self.items()})


class _Tokenizer:
    """Stands in for AutoTokenizer and AutoProcessor."""

    seen = []

    @classmethod
    def from_pretrained(cls, name):
        return cls()

    def apply_chat_template(self, msgs, tokenize, add_generation_prompt):
        assert not tokenize and add_generation_prompt
        return " | ".join(str(m["content"]) for m in msgs)

    def __call__(self, texts=None, images=None, videos=None, return_tensors=None, text=None):
        type(self).seen.append(dict(text=texts or text, images=images, videos=videos))
        return _Batch(input_ids=torch.tensor([[5, 6, 7]]))

    def decode(self, ids, skip_special_tokens):
        return f" expanded {ids.tolist()} "

    def batch_decode(self, ids, skip_special_tokens):
        return [self.decode(row, skip_special_tokens) for row in ids]


class _Model:
    """Stands in for AutoModelForCausalLM / Qwen2VLForConditionalGeneration:
    `generate` appends two tokens, and only to inputs on the model's device."""

    fail = False

    @classmethod
    def from_pretrained(cls, name):
        if cls.fail:
            raise OSError(f"no checkpoint at {name}")
        return cls()

    def to(self, device):
        self.device = torch.device(device)
        return self

    def eval(self):
        return self

    def generate(self, input_ids, max_new_tokens):
        assert input_ids.device == self.device
        return torch.cat([input_ids, torch.tensor([[8, 9]], device=self.device)], 1)


@pytest.fixture
def fake_transformers(monkeypatch):
    mod = types.ModuleType("transformers")
    mod.AutoTokenizer = mod.AutoProcessor = _Tokenizer
    mod.AutoModelForCausalLM = mod.Qwen2VLForConditionalGeneration = _Model
    monkeypatch.setitem(sys.modules, "transformers", mod)
    monkeypatch.setattr(_Model, "fail", False)
    _Tokenizer.seen.clear()
    return mod


def test_qwen_expander_runs_on_its_device(fake_transformers):
    exp = tpe.get_prompt_expander("qwen", model_name="local/qwen", device="cpu")
    assert isinstance(exp, tpe.QwenPromptExpander) and exp.device == torch.device("cpu")
    out = exp("a cat", tar_lang="en", seed=2)
    assert out.status and out.prompt == "expanded [8, 9]"
    assert out.system_prompt == tpe.LM_EN_SYS_PROMPT and out.seed == 2
    assert exp._model.device == exp.device
    assert _Tokenizer.seen[0]["text"] == [f"{tpe.LM_EN_SYS_PROMPT} | a cat"]


def test_qwen_vl_expander_feeds_the_image(fake_transformers, tmp_path):
    from PIL import Image

    path = tmp_path / "img.png"
    Image.fromarray(np.zeros((56, 84, 3), np.uint8)).save(path)
    exp = tpe.get_prompt_expander("qwen", model_name="local/qwen-vl", is_vl=True,
                                  device="cpu")
    out = exp("a cat", tar_lang="zh", image=str(path), seed=4)
    assert out.status and out.prompt == "expanded [8, 9]"
    assert out.system_prompt == tpe.VL_ZH_SYS_PROMPT
    (call,) = _Tokenizer.seen
    assert call["videos"] is None and len(call["images"]) == 1
    assert call["images"][0].size == tqv.fetch_image({"image": str(path)}).size


def test_qwen_expander_failure_keeps_the_prompt(fake_transformers, monkeypatch, caplog):
    monkeypatch.setattr(_Model, "fail", True)
    exp = tpe.get_prompt_expander("qwen", model_name="missing", device="cpu")
    with caplog.at_level("WARNING"):
        out = exp("a dog", seed=1)
    assert not out.status and out.prompt == "a dog" and "no checkpoint" in out.message
    assert "prompt kept" in caplog.text


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the card")
def test_qwen_expander_wants_the_card_by_default():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpe.get_prompt_expander("qwen")
