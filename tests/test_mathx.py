"""Math-layer tests: matrices vs hand-computed/nalgebra-semantic values."""

import math

import numpy as np
import pytest

from ash_renderer import mathx
from ash_renderer.camera import Camera, CameraController, orbit_path


def test_look_at_identity_forward_z():
    # Looking down +z from origin with up=-y: the reference's startup pose.
    m = mathx.look_at_rh([0, 0, 0], [0, 0, 1], [0, -1, 0])
    # s = f x up = (0,0,1) x (0,-1,0) = (1,0,0); u = s x f = (0,-1,0)
    expect = np.array(
        [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    np.testing.assert_array_equal(m, expect)


def test_look_at_translation():
    eye = np.array([1.0, 2.0, 3.0], dtype=np.float32)
    m = mathx.look_at_rh(eye, eye + np.array([0, 0, 1], np.float32), [0, -1, 0])
    # eye maps to origin
    p = m @ np.array([1, 2, 3, 1], np.float32)
    np.testing.assert_allclose(p, [0, 0, 0, 1], atol=1e-6)


def test_perspective_matches_nalgebra_formula():
    aspect, fovy, znear, zfar = 4 / 3, 45.0, 0.01, 100.0
    m = mathx.perspective(aspect, fovy, znear, zfar)
    f = 1.0 / np.tan(np.float32(fovy) / 2.0)
    assert m[0, 0] == pytest.approx(f / aspect, rel=1e-6)
    assert m[1, 1] == pytest.approx(f, rel=1e-6)
    assert m[2, 2] == pytest.approx(-(zfar + znear) / (zfar - znear), rel=1e-6)
    assert m[2, 3] == pytest.approx(-2 * zfar * znear / (zfar - znear), rel=1e-6)
    assert m[3, 2] == -1.0
    # GL-style depth: z_ndc = -1 at znear, +1 at zfar
    for z, expect in ((znear, -1.0), (zfar, 1.0)):
        c = m @ np.array([0, 0, -z, 1], np.float32)
        assert c[2] / c[3] == pytest.approx(expect, rel=1e-4)


def test_fov_quirk_preserved():
    # fovy=45.0 *radians* (the reference's bug, camera.rs:35): effective
    # tan(22.5 rad) = tan(22.5 - 7*pi) ~ 0.5586
    m = mathx.perspective(1.0, 45.0, 0.01, 100.0)
    assert m[1, 1] == pytest.approx(1.0 / math.tan(22.5 - 7 * math.pi), rel=1e-5)


def test_transform_builders():
    t = mathx.translation([1, 2, 3])
    p = t @ np.array([0, 0, 0, 1], np.float32)
    np.testing.assert_array_equal(p, [1, 2, 3, 1])
    r = mathx.rotation_y(math.pi / 2)
    p = r @ np.array([1, 0, 0, 1], np.float32)
    np.testing.assert_allclose(p, [0, 0, -1, 1], atol=1e-6)
    s = mathx.scaling([2, 3, 4])
    p = s @ np.array([1, 1, 1, 1], np.float32)
    np.testing.assert_array_equal(p, [2, 3, 4, 1])
    c = mathx.compose(t, s)
    p = c @ np.array([1, 1, 1, 1], np.float32)
    np.testing.assert_allclose(p, [3, 5, 7, 1], atol=1e-6)


def test_camera_defaults_match_reference():
    cam = Camera()
    # camera.rs:29-38
    np.testing.assert_array_equal(cam.position, [0, 0, 0])
    assert cam.phi == pytest.approx(math.pi / 2)
    assert cam.theta == 0.0
    np.testing.assert_array_equal(cam.up, [0, -1, 0])
    assert cam.fovy == 45.0 and cam.znear == 0.01 and cam.zfar == 100.0
    # forward at startup is +z (camera.rs:40-47 with phi=pi/2, theta=0)
    np.testing.assert_allclose(cam.forward(), [0, 0, 1], atol=1e-7)


def test_camera_view_matrix_negative_y():
    cam = Camera()
    v = cam.view_matrix()
    # negative_y * look_at: y row negated vs raw look_at
    expect = np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    np.testing.assert_allclose(v, expect, atol=1e-7)


def test_camera_forward_spherical():
    cam = Camera(phi=math.pi / 2, theta=math.pi / 2)
    np.testing.assert_allclose(cam.forward(), [1, 0, 0], atol=1e-7)
    cam = Camera(phi=0.0, theta=0.0)  # phi=0 is "up" = -y? forward=(0,-1,0)
    np.testing.assert_allclose(cam.forward(), [0, -1, 0], atol=1e-7)


def test_controller_matches_reference_semantics():
    cam = Camera()
    ctl = CameraController(speed=0.5, mouse_sens=0.1)
    ctl.forward_pressed = True
    ctl.update_camera(cam)
    np.testing.assert_allclose(cam.position, [0, 0, 0.5], atol=1e-7)
    # right = forward x (-y) = (0,0,1) x (0,-1,0) = (1,0,0)... cross((0,0,1),(0,-1,0)) = (0*0-1*(-1), 1*0-0*0, 0*(-1)-0*0) = (1,0,0)
    ctl.forward_pressed = False
    ctl.right_pressed = True
    ctl.update_camera(cam)
    np.testing.assert_allclose(cam.position, [0.5, 0, 0.5], atol=1e-7)
    ctl.right_pressed = False
    ctl.process_mouse(2.0, 3.0)
    ctl.update_camera(cam)
    assert cam.theta == pytest.approx(0.2)
    assert cam.phi == pytest.approx(math.pi / 2 + 0.3)
    assert ctl.mouse_delta_x == 0.0 and ctl.mouse_delta_y == 0.0


def test_orbit_path_looks_at_center():
    cams = orbit_path(8, radius=5.0)
    for cam in cams:
        f = cam.forward()
        to_center = -cam.position / np.linalg.norm(cam.position)
        np.testing.assert_allclose(f, to_center, atol=1e-5)
