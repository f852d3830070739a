"""The port's perception plane (perception/, its CLI, Session._build_perception,
the server CLI's flags) against the JAX package's.

``TPUYoloPerception`` with the tiny YOLOv10 of tests/test_torch_yolo.py in
float32, the face-attribute nets at width 0.125 and the CRAFT+CRNN reader
(CRAFT at width 0.125, the CRNN at 32 channels and hidden width 16), all on
seeded weights carried across with ``convert.py``, gives the JAX package's
summaries character for character on the same frames; the reader's map is
fabricated in both packages (as tests/test_ocr.py does), so that text is
found. The detectors run at conf 0.52, where a score that JAX and the port
place on either side of the threshold would take a distance of under 3e-4
from it (none here).
"""
from __future__ import annotations

import asyncio
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu import perception as jperception
from mere_fusion_tpu.cli import build_parser as jax_build_parser
from mere_fusion_tpu.cli import config_from_args as jax_config_from_args
from mere_fusion_tpu.models import face_attrs as jfa
from mere_fusion_tpu.models import ocr as jocr
from mere_fusion_tpu.models import yolo as jyolo
from mere_fusion_tpu.perception import __main__ as jcli
from mere_fusion_tpu.server import upstream as jupstream
from mere_fusion_tpu_torch import cli, perception
from mere_fusion_tpu_torch.asr import FakeBackend
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import (
    craft_from_flax,
    crnn_from_flax,
    face_attrs_from_flax,
    yolo_from_flax,
)
from mere_fusion_tpu_torch.llm import EchoLLM
from mere_fusion_tpu_torch.models import face_attrs, ocr, yolo
from mere_fusion_tpu_torch.perception import __main__ as pcli
from mere_fusion_tpu_torch.server import upstream
from mere_fusion_tpu_torch.server.sessions import Session
from tests.test_torch_face_attrs import _seeded as seeded_plain
from tests.test_torch_ocr import _maps
from tests.test_torch_ocr import _seeded as seeded_ocr
from tests.test_torch_yolo import IMGSZ, NC, TINY_SPEC, seeded_tree
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
CONF = 0.52
FA_WIDTH = 0.125
OC, HIDDEN = 32, 16
N_CLS = 1 + len(ocr.DEFAULT_CHARSET)
# the seeded detector's most frequent class is 2: call it a person
NAMES = [f"c{i}" for i in range(NC)]
NAMES[2] = "person"


@pytest.fixture(scope="module")
def weights():
    """Seeded flax variables of the detector, the attribute nets, the reader."""
    w = {"yolo": seeded_tree(jyolo.YoloV10(scale="l", nc=NC, imgsz=IMGSZ, spec=TINY_SPEC),
                             jnp.zeros((1, IMGSZ, IMGSZ, 3)), seed=0)}
    for i, (task, n) in enumerate((("age", 101), ("gender", 2))):
        w[task] = seeded_plain(jfa.VGGFaceAttr(n, width=FA_WIDTH), (1, 224, 224, 3), seed=i)
    w["emotion"] = seeded_plain(jfa.EmotionNet(width=FA_WIDTH), (1, 48, 48, 1), seed=9)
    w["craft"] = seeded_ocr(jocr.CRAFT(width=0.125), (1, 64, 64, 3), seed=0)
    w["crnn"] = seeded_ocr(jocr.CRNN(N_CLS, OC, HIDDEN), (1, 64, 64, 1), seed=1)
    return w


def _jax_perception(w, fps_throttle=3, conf=CONF):
    det = jyolo.YoloDetector(w["yolo"], scale="l", nc=NC, imgsz=IMGSZ, max_det=300,
                             names=NAMES, dtype=jnp.float32, spec=TINY_SPEC)
    fa = jfa.FaceAttributeAnalyzer(age=w["age"], gender=w["gender"], emotion=w["emotion"],
                                   width=FA_WIDTH)
    reader = jocr.TextReader(det_variables=w["craft"], rec_variables=w["crnn"], width=0.125)
    crnn = jocr.CRNN(N_CLS, OC, HIDDEN)
    reader._rec = jax.jit(lambda v, x: jnp.argmax(crnn.apply(v, x), axis=-1))
    reader._rec_conf = jax.jit(lambda v, x: jnp.max(jax.nn.softmax(crnn.apply(v, x), -1), -1))
    reader._det = lambda v, x: jnp.asarray(_maps(x.shape[1] // 2)[None])
    return jperception.TPUYoloPerception(detector=det, fps_throttle=fps_throttle, conf=conf,
                                         face_attrs=fa, ocr=reader)


def _port_perception(w, fps_throttle=3, conf=CONF):
    model = yolo.build_yolo(yolo_from_flax(w["yolo"], scale="l", nc=NC, spec=TINY_SPEC),
                            scale="l", nc=NC, imgsz=IMGSZ, spec=TINY_SPEC, device=CPU)
    det = yolo.YoloDetector(model=model, names=NAMES, device=CPU)
    fa = face_attrs.FaceAttributeAnalyzer(
        age=face_attrs_from_flax(w["age"], 101, FA_WIDTH),
        gender=face_attrs_from_flax(w["gender"], 2, FA_WIDTH),
        emotion=face_attrs_from_flax(w["emotion"], None, FA_WIDTH), width=FA_WIDTH, device=CPU)
    reader = ocr.TextReader(det_state=craft_from_flax(w["craft"], width=0.125), width=0.125,
                            device=CPU)
    reader.rec = ocr.CRNN(N_CLS, OC, HIDDEN).eval()
    reader.rec.load_state_dict(crnn_from_flax(w["crnn"], N_CLS, OC, HIDDEN), strict=True)
    reader.detection_maps = lambda canvas: _maps(canvas.shape[0] // 2)
    return perception.TPUYoloPerception(detector=det, fps_throttle=fps_throttle, conf=conf,
                                        face_attrs=fa, ocr=reader)


def _frames(n: int, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def _pair(weights):
    return _jax_perception(weights), _port_perception(weights)


_STATE = ("fps_throttle", "conf", "use_ocr", "face_attrs", "ocr", "_count")


@pytest.fixture()
def pair(_pair):
    """(JAX's TPUYoloPerception, the port's), as built, for one test."""
    saved = [{k: getattr(p, k) for k in _STATE} for p in _pair]
    yield _pair
    for p, state in zip(_pair, saved):
        for k, v in state.items():
            setattr(p, k, v)


def test_summaries_as_jax(pair):
    """Throttled, object counts, the face sentence and the visible text,
    character for character."""
    jp, pp = pair
    frames = _frames(7)
    want = [jp.process_frame(f) for f in frames]
    got = [pp.process_frame(f) for f in frames]
    assert got == want
    assert [s is None for s in got] == [True, True, False, True, True, False, True]
    for s in filter(None, got):
        assert s.startswith("scene contains ") and "person(s)" in s
        assert "; person appears " in s and " years old, " in s
        assert "; visible text: " in s


def test_nothing_notable_as_jax(pair):
    jp, pp = pair
    for p in pair:
        p.fps_throttle, p.conf = 1, 1.1
    frame = _frames(1)[0]
    got = pp.process_frame(frame)
    assert got == jp.process_frame(frame)
    assert got.startswith("scene contains nothing notable; visible text: ")
    jp.use_ocr = pp.use_ocr = False
    assert pp.process_frame(frame) == jp.process_frame(frame) == "scene contains nothing notable"


def test_library_fallbacks_as_jax(pair, monkeypatch):
    """Without the port's nets, a person seen goes to deepface and the text
    to easyocr, when importable; absent here, both add nothing, as in JAX."""
    import sys

    monkeypatch.setitem(sys.modules, "deepface", None)
    monkeypatch.setitem(sys.modules, "easyocr", None)
    jp, pp = pair
    for p in pair:
        p.fps_throttle, p.face_attrs, p.ocr = 1, None, None
    frame = _frames(1)[0]
    got = pp.process_frame(frame)
    assert got == jp.process_frame(frame) and "person(s)" in got and ";" not in got


@pytest.mark.parametrize("spec", ["", "random", "craft=a.pth,crnn=b.pth",
                                  " age = x.h5 ,emotion=e.h5", "justapath.pth", "craft=,crnn=b"])
def test_parse_perception_spec_as_jax(spec):
    try:
        want = jperception.parse_perception_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match="key=path"):
            perception.parse_perception_spec(spec)
        assert "key=path" in str(e)
        return
    assert perception.parse_perception_spec(spec) == want


def test_make_perception_every_backend(monkeypatch):
    import sys

    assert isinstance(perception.make_perception("stub", fps_throttle=4),
                      perception.StubPerception)
    monkeypatch.setitem(sys.modules, "ultralytics", None)
    for pkg in (perception, jperception):
        with pytest.raises(ImportError):
            pkg.make_perception("yolo")
        with pytest.raises(ValueError, match="unknown perception backend"):
            pkg.make_perception("cctv")
    for kind in ("yolo-tpu", "yolo_tpu"):
        p = perception.make_perception(kind, scale="n", device=CPU, fps_throttle=2,
                                       face_attrs="random", ocr="random", conf=0.3)
        assert isinstance(p, perception.TPUYoloPerception) and p.device == CPU
        assert p.detector.model.model[0].conv.weight.dtype == torch.bfloat16
        assert p.detector.model.model[0].conv.out_channels == 16            # scale n
        assert isinstance(p.face_attrs, face_attrs.FaceAttributeAnalyzer)
        assert sorted(p.face_attrs.nets) == ["age", "emotion", "gender"]
        assert isinstance(p.ocr, ocr.TextReader) and (p.fps_throttle, p.conf) == (2, 0.3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perception.make_perception("yolo-tpu", scale="n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perception.make_face_attrs("random")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perception.make_ocr("random")
    with pytest.raises(ValueError, match="unknown face_attrs spec"):
        perception.make_face_attrs("all", device=CPU)
    with pytest.raises(ValueError, match="unknown ocr spec"):
        perception.make_ocr(3, device=CPU)


class _Engine:
    def __init__(self, device=None):
        self.device = device
        self.phrases: list[str] = []

    def put_msg_txt(self, msg: str) -> None:
        self.phrases.append(msg)

    def pause_talk(self) -> None:
        pass


def test_session_builds_perception_from_config(tmp_path, monkeypatch):
    """perception.* → the backend, on the session's device; a ckpt's tree
    once a (ckpt, device), shared by the sessions there."""
    path = str(tmp_path / "yolov10n.pt")
    state = yolo.build_yolo(None, scale="n", device=CPU, seed=3).state_dict()
    torch.save({"model": state}, path)
    cfg = Config().override(**{"perception.backend": "yolo-tpu", "perception.ckpt": path,
                               "perception.scale": "n", "perception.fps_throttle": 4,
                               "perception.conf": 0.4, "perception.face_attrs": "random",
                               "perception.ocr": ""})
    built = [Session(s, engine=_Engine(CPU), cfg=cfg)._build_perception() for s in "ab"]
    a, b = built
    assert isinstance(a, perception.TPUYoloPerception) and a.device == CPU
    assert (a.fps_throttle, a.conf, a.ocr) == (4, 0.4, None)
    assert a.face_attrs.device == CPU
    wa, wb = (p.detector.model.model[2].m[0].cv1.conv.weight for p in built)
    assert wa.dtype == torch.bfloat16 and wa.data_ptr() == wb.data_ptr()
    torch.testing.assert_close(wa, state["model.2.m.0.cv1.conv.weight"].bfloat16())
    stub = Session("s", engine=_Engine(CPU), cfg=Config().override(
        **{"perception.fps_throttle": 7}))._build_perception()
    assert isinstance(stub, perception.StubPerception) and stub.fps_throttle == 7
    # no card and no device: the build raises, it does not fall back
    session = Session("n", engine=_Engine(None), cfg=Config().override(
        **{"perception.backend": "yolo-tpu", "perception.scale": "n"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        session._build_perception()


@pytest.mark.parametrize("argv", [
    [],
    ["--perception", "yolo-tpu", "--yolo_ckpt", "y.pt", "--yolo_scale", "s",
     "--perception_fps", "5", "--face_attrs", "random", "--ocr", "craft=a.pth,crnn=b.pth"],
    ["--perception", "yolo", "--yolo_ckpt", "yolov10x.pt"],
], ids=["defaults", "yolo-tpu", "yolo"])
def test_cli_flags_map_as_jax(argv):
    got = cli.config_from_args(cli.build_parser().parse_args(argv)).perception
    want = jax_config_from_args(jax_build_parser().parse_args(argv)).perception
    assert vars(got) == vars(want)


def test_perception_cli_over_an_image_directory(tmp_path, capsys, monkeypatch):
    import cv2

    for i, f in enumerate(_frames(6)):
        cv2.imwrite(str(tmp_path / f"f{i:03d}.png"), f)
    out = {}
    for name, mod in (("port", pcli), ("jax", jcli)):
        mod.main([str(tmp_path), "--backend", "stub", "--fpsthrottle", "2", "-fs", "1"])
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"] and out["port"].count("\n") == 2
    assert [len(list(m.iter_frames(str(tmp_path), 2, 3))) for m in (pcli, jcli)] == [3, 3]

    seen = {}
    monkeypatch.setattr(perception, "TPUYoloPerception",
                        lambda **kw: seen.update(kw) or perception.StubPerception(1))
    pcli.main([str(tmp_path), "--backend", "yolo-tpu", "--face-attrs", "random", "--ocr",
               "craft=a.pth,crnn=b.pth", "--framelimit", "1", "--device", "cpu",
               "--scale", "n", "--no-deepface"])
    assert seen["face_attrs"] == "random" and seen["ocr"] == {"craft": "a.pth", "crnn": "b.pth"}
    assert (seen["device"], seen["scale"], seen["use_deepface"]) == ("cpu", "n", False)
    assert capsys.readouterr().out.startswith("frame 0: 128x96 ")
    monkeypatch.setattr(shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        list(pcli.iter_frames("rtp://0.0.0.0:19292"))


def test_perception_cli_yolo_tpu_on_the_cpu(tmp_path, capsys):
    """The CLI's yolo-tpu backend end to end on the CPU (scale n at 640 px,
    face attributes and OCR with seeded weights)."""
    import cv2

    for i, f in enumerate(_frames(2)):
        cv2.imwrite(str(tmp_path / f"f{i}.png"), f)
    pcli.main([str(tmp_path), "--backend", "yolo-tpu", "--device", "cpu", "--scale", "n",
               "--fpsthrottle", "2", "--face-attrs", "random", "--ocr", "random"])
    (line,) = capsys.readouterr().out.splitlines()
    assert line.startswith("frame 1: scene contains ")


class _CameraFrame:
    def __init__(self, image):
        self.image = image

    def to_ndarray(self, format=None):
        assert format == "bgr24"
        return self.image


class _CameraTrack:
    kind = "video"

    def __init__(self, frames):
        self.frames = list(frames)

    async def recv(self):
        if not self.frames:
            await asyncio.sleep(3600)
        await asyncio.sleep(0)
        return _CameraFrame(self.frames.pop(0))


def test_lip_session_camera_reaches_the_brain(pair, tmp_path):
    """A Wav2Lip session with EchoLLM: the caller's camera track through
    attach_upstream_track → TPUYoloPerception (on an executor thread) →
    brain.video_produce, the summaries JAX's VideoUpstream gives; the reply
    to the caller's words carries the last one."""
    from mere_fusion_tpu_torch.engines.avatar import synthesize_avatar
    from mere_fusion_tpu_torch.engines.lip import LipReal

    cfg = Config().override(**{"avatar.batch_size": 2, "tts.backend": "procedural",
                               "avatar.dtype": "float32"})
    engine = LipReal(cfg, avatar=synthesize_avatar(str(tmp_path / "avatar"), n_frames=4),
                     device=CPU)
    phrases: list = []
    engine.put_msg_txt = phrases.append
    frames = _frames(9, seed=11)
    echo, messages = EchoLLM("I saw {text}. "), []
    stream = echo.stream_chat
    echo.stream_chat = lambda m: (messages.append(m), stream(m))[1]
    session = Session("cam", engine=engine, cfg=cfg, llm=echo,
                      asr_backend=FakeBackend([]), perception=pair[1])
    seen: list = []

    async def drive():
        session.player = SimpleNamespace(stop=lambda: None)
        session.ensure_upstream()
        produce = session.brain.video_produce
        session.brain.video_produce = lambda s: (seen.append(s), produce(s))
        task = upstream.attach_upstream_track(session, _CameraTrack(frames))
        session._consumers.append(task)
        for _ in range(3000):
            if len(seen) == 3:
                break
            await asyncio.sleep(0.01)
        session.brain.text_produce("hello")
        for _ in range(3000):
            if phrases:
                break
            await asyncio.sleep(0.01)
        await session.close()
        assert task.cancelled()

    asyncio.run(drive())
    want: list = []
    up = jupstream.VideoUpstream(pair[0], SimpleNamespace(video_produce=want.append))
    for f in frames:
        up.process_frame(f)
    assert seen == want and len(want) == 3
    assert messages[0][-1]["content"] == f"text: hello\nscene: {want[-1]}"
    assert phrases[0].startswith("I saw text: hello")
    assert not session.brain._thread.is_alive()
