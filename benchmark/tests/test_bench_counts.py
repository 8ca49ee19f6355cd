"""The FLOP and byte counts against hand counts."""
import peaks
import manifest


def test_nature_cnn_forward_at_224_and_folded_at_112():
    cnn = manifest.counts("nature_cnn")
    # conv1 55*55*32*(8*8*3), conv2 26*26*64*(4*4*32), conv3 24*24*64*(3*3*64),
    # fc 36864*512 multiply-adds, two FLOPs each.
    hand = 2 * (55 * 55 * 32 * 192 + 26 * 26 * 64 * 512 + 24 * 24 * 64 * 576 + 36864 * 512)
    layers = cnn.layer_flops((224, 224, 3), 4)
    assert sum(layers[:4]) == hand
    assert round(cnn.forward_flops((224, 224, 3), 4) / 1e6, 1) == 161.7
    # Folded: conv1 is 4x4 stride 2 on the 112x112 trace, 55x55 outputs.
    folded = cnn.layer_flops((112, 112, 3), 6, input_scale=2)
    assert folded[0] == 2 * 55 * 55 * 32 * 4 * 4 * 3
    assert folded[1:4] == layers[1:4]
    assert round(cnn.forward_flops((112, 112, 3), 6, 2) / 1e6, 1) == 133.8


def test_update_flops_counts_rollout_and_epochs():
    cnn = manifest.counts("nature_cnn")
    f = cnn.layer_flops((224, 224, 3), 4)
    fwd = sum(f)
    n, t, e = 256, 128, 4
    want = (n * t + n) * fwd + e * n * t * (3 * fwd - f[0])
    cfg = {"frame": [224, 224, 3], "n_actions": 4, "input_scale": 1}
    traffic = {"num_envs": n, "n_steps": t, "noptepochs": e, "dp": 1}
    assert cnn.update_flops(cfg, traffic) == want
    # On a mesh, one card's share of the envs.
    assert cnn.update_flops(cfg, dict(traffic, num_envs=4 * n, dp=4)) == want
    # About 64 TFLOP an update of the MobileRobot cell.
    assert 60e12 < want < 70e12


def test_render_bounds():
    r2 = manifest.counts("render2d")
    # 256 frames of 224x224x3 dominate: about 0.0116 ms at 3.35 TB/s.
    assert abs(peaks.roofline_seconds(r2.bytes_moved(256, 224, 224), 0) * 1e3 - 0.0116) < 1e-4
    r3 = manifest.counts("render3d")
    assert r3.bytes_moved(1024, 112, 112) == 1024 * 10 * 4 + 1024 * 112 * 112 * 3
    assert r3.flops(1024, 112, 112) == 0
