"""The port's face detector stack (RetinaFace-ResNet50 + FAN,
`omni_avsr_tpu_torch/preprocess/{retinaface,fan,detector}.py`,
`convert/detector_torch.py`) against the JAX package's, on the same
`init_*` trees (numpy `RandomState`, bit-equal in both packages), in f32:

  - the forwards within rtol/atol 2e-3, the JAX detector tests' bar
    (tests/test_detector_models.py), on 64x80 frames and 64x64 crops. At
    init the networks have no BN shift and zero biases, so their outputs
    scale with their input and reach an RMS of ~2e4 here (RetinaFace); the
    absolute part of the bar is taken at that scale (2e-3 x the output's
    RMS where it exceeds 1), and the relative L2 difference is held to 1e-5;
  - anchors, box decode and NMS equal; crop and heatmap decode within 1e-5;
  - the converters give equal trees from one public-layout state dict, and
    the port's exporters read back to the same tree;
  - the biased random-weight detector (face class +6, as
    tests/test_detector_models.py runs it) gives the JAX detector's boxes
    and landmarks within 1e-3 px, and None where it gives None. Its box
    head is scaled by 1e-5 rather than 1e-3: at 1e-3 these frames'
    regressions reach the decode's exp clamp, boxes ~1e5 px wide whose
    float32 spacing alone exceeds 1e-3 px;
  - `build_detector`'s decision table, `jax` a synonym of `torch`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu.convert import detector_torch as JC
from omni_avsr_tpu.preprocess import detector as JD
from omni_avsr_tpu.preprocess import fan as JF
from omni_avsr_tpu.preprocess import retinaface as JR
from omni_avsr_tpu_torch.convert import detector_torch as PC
from omni_avsr_tpu_torch.preprocess import detector as PD
from omni_avsr_tpu_torch.preprocess import fan as PF
from omni_avsr_tpu_torch.preprocess import retinaface as PR


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _biased(rf, box_scale=1e-5):
    """Face-class bias so detections fire, box head scaled so random
    regressions stay near their anchors (tests/test_detector_models.py:349-353)."""
    for h in rf["class_head"]:
        h["b"][1::2] += 6.0
    for h in rf["bbox_head"]:
        h["w"] *= box_scale
    return rf


def _assert_close(ours, theirs):
    """rtol/atol 2e-3, the absolute part at the output's scale, and
    relative L2 within 1e-5 (see the module docstring)."""
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    scale = max(1.0, float(np.sqrt(np.mean(theirs.astype(np.float64) ** 2))))
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-3 * scale)
    assert np.linalg.norm(ours - theirs) <= 1e-5 * np.linalg.norm(theirs)


@pytest.fixture(scope="module")
def trees():
    return PC.init_retinaface(0), PC.init_fan(0)


def test_init_trees_bit_equal(trees):
    rf, fan = trees
    _assert_trees_equal(rf, JC.init_retinaface(0))
    _assert_trees_equal(fan, JC.init_fan(0))
    _assert_trees_equal(PC.init_fan(3, num_modules=1), JC.init_fan(3, num_modules=1))


def test_retinaface_forward_matches_jax(trees):
    rf, _ = trees
    x = (np.random.RandomState(1).randn(2, 64, 80, 3) * 20).astype(np.float32)
    ours = PR.retinaface_forward(PR.conv_layout(rf, "cpu"), torch.as_tensor(x))
    theirs = JR.retinaface_forward(rf, jnp.asarray(x))
    for a, b in zip(ours, theirs):
        _assert_close(a.numpy(), b)


def test_fan_forward_matches_jax(trees):
    _, fan = trees
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    ours = PF.fan_forward(PR.conv_layout(fan, "cpu"), torch.as_tensor(x))
    assert ours.shape == (2, 16, 16, 68)
    _assert_close(ours.numpy(), JF.fan_forward(fan, jnp.asarray(x)))


def test_priors_decode_nms_equal():
    for hw in ((64, 80), (96, 128), (224, 224), (101, 77)):
        np.testing.assert_array_equal(PR.priors_for(*hw), JR.priors_for(*hw))
    priors = PR.priors_for(96, 128)
    loc = (np.random.RandomState(3).randn(len(priors), 4) * 8).astype(np.float32)
    loc[0] = 1e6  # the exp clamp
    np.testing.assert_array_equal(PR.decode_boxes(loc, priors), JR.decode_boxes(loc, priors))
    boxes = np.abs(np.random.RandomState(4).randn(200, 4) * 30).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    scores = np.random.RandomState(5).rand(200).astype(np.float32)
    assert PR.nms(boxes, scores, 0.4) == JR.nms(boxes, scores, 0.4)


def test_crop_and_heatmap_decode_match_jax():
    rng = np.random.RandomState(6)
    frames = rng.randint(0, 255, (3, 90, 120, 3), dtype=np.uint8)
    # inside the frame, hanging off the left edge, larger than the frame
    boxes = np.array([[30.5, 20.25, 70.0, 66.0], [-30.0, 20.0, 30.0, 80.0],
                      [-50.0, -40.0, 200.0, 150.0]], np.float32)
    patches, centers, sides = PF.crop_faces(torch.as_tensor(frames), boxes)
    for i in range(3):
        p, c, s = JF.crop_face(frames[i], boxes[i])
        np.testing.assert_allclose(patches[i].numpy(), p, atol=1e-5)
        np.testing.assert_array_equal(centers[i], c)
        assert sides[i] == s
    hm = rng.rand(3, 64, 64, 68).astype(np.float32)
    hm[0, 10, 20, :] = 2.0  # a peak with an equal pair of neighbours: no shift
    hm[1, 0, 5, :] = 2.0  # a peak on the border
    ours = PF.heatmaps_to_landmarks(torch.as_tensor(hm), centers, sides)
    for i in range(3):
        np.testing.assert_allclose(ours[i], JF.heatmaps_to_landmarks(hm[i], centers[i], sides[i]),
                                   atol=1e-5)
    for bad in ([np.nan, 0, 10, 10], [10, 10, 10, 40], [10, 10, 40, 5]):
        with pytest.raises(ValueError):
            PF.crop_faces(torch.as_tensor(frames[:1]), np.array([bad], np.float32))


def test_converters_match_jax():
    from tests.test_detector_models import TorchFAN, TorchRetinaFace

    torch.manual_seed(0)
    for net, ours, theirs in ((TorchRetinaFace(), PC.convert_retinaface, JC.convert_retinaface),
                              (TorchFAN(num_modules=2), PC.convert_fan, JC.convert_fan)):
        for m in net.modules():  # random BN statistics, so the fold is exercised
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.02)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.data.uniform_(0.5, 1.5)
        sd = net.state_dict()
        _assert_trees_equal(ours(sd), theirs(sd))


def test_state_dict_exporters_round_trip(trees):
    rf, fan = trees
    _assert_trees_equal(PC.convert_retinaface(PC.retinaface_state_dict(rf)), rf)
    _assert_trees_equal(PC.convert_fan(PC.fan_state_dict(fan)), fan)


def test_detector_matches_jax(trees):
    import copy

    rf, fan = _biased(copy.deepcopy(trees[0])), trees[1]
    frames = np.random.RandomState(5).randint(0, 255, size=(3, 96, 128, 3), dtype=np.uint8)
    port = PD.TorchLandmarksDetector(rf, fan, threshold=0.5, device="cpu", batch=2)
    ours_faces = port.faces(torch.as_tensor(frames))
    for frame, faces in zip(frames, ours_faces):
        theirs = JR.detect_faces(rf, frame, threshold=0.5)
        assert faces.shape == theirs.shape and len(faces) > 0
        np.testing.assert_allclose(faces[:, :4], theirs[:, :4], atol=1e-3)
    ours = port(frames)
    theirs = JD.JaxLandmarksDetector(rf, fan, threshold=0.5)(frames)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape == (68, 2) and a.dtype == np.float64
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_detector_none_where_jax_none(trees):
    import copy

    rf, fan = trees
    rf = copy.deepcopy(rf)
    for h in rf["class_head"]:  # no anchor's face score passes the threshold
        h["w"] *= 0.0
        h["b"][1::2] -= 10.0
    frames = np.random.RandomState(7).randint(0, 255, size=(2, 64, 80, 3), dtype=np.uint8)
    assert PD.TorchLandmarksDetector(rf, fan, device="cpu")(frames) == [None, None]
    assert JD.JaxLandmarksDetector(rf, fan)(frames) == [None, None]


def test_largest_face_and_center_fallback():
    faces = np.array([[0, 0, 10, 30, 0.9], [0, 0, 20, 20, 0.8], [5, 5, 25, 25, 0.7]], np.float32)
    assert PD.largest_face_index(faces) == JD.largest_face_index(faces) == 0
    frames = np.zeros((3, 120, 160, 3), np.uint8)
    for a, b in zip(PD.CenterFaceLandmarker()(frames), JD.CenterFaceLandmarker()(frames)):
        np.testing.assert_array_equal(a, b)


def test_build_detector_decision_table(trees, tmp_path):
    rf, fan = trees
    rw, fw = str(tmp_path / "Resnet50_Final.pth"), str(tmp_path / "fan.pth")
    torch.save({"state_dict": {"module." + k: torch.from_numpy(v)
                               for k, v in PC.retinaface_state_dict(rf).items()}}, rw)
    torch.save({k: torch.from_numpy(v) for k, v in PC.fan_state_dict(fan).items()}, fw)
    for name in ("auto", "torch", "jax"):  # `jax` is the JAX CLIs' name for it
        det = PD.build_detector(name, device="cpu", retinaface_weights=rw, fan_weights=fw)
        assert isinstance(det, PD.TorchLandmarksDetector) and det.device.type == "cpu"
    loaded = dict(_leaves(det.rf))
    laid = dict(_leaves(PR.conv_layout(rf, "cpu")))
    assert loaded.keys() == laid.keys()
    for k in laid:
        np.testing.assert_array_equal(loaded[k], laid[k])
    for name in ("torch", "jax"):
        with pytest.raises(ValueError, match="needs --retinaface-weights"):
            PD.build_detector(name, device="cpu", retinaface_weights=rw)
    assert isinstance(PD.build_detector("auto", device="cpu"), PD.CenterFaceLandmarker)
    assert isinstance(PD.build_detector("center", device="cpu", retinaface_weights=rw,
                                        fan_weights=fw), PD.CenterFaceLandmarker)
    with pytest.raises(ImportError):  # no ibug packages here
        PD.build_detector("ibug", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PD.build_detector("auto", retinaface_weights=rw, fan_weights=fw)


def test_no_cuda_no_fallback(trees):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rf, fan = trees
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.TorchLandmarksDetector(rf, fan)
    assert jax.default_backend() == "cpu"
