"""The port's batching server (serve/server.py) and HTTP CLI (cli/serve.py):
every case of tests/test_serve.py against the port's server, and the port's
server against the JAX package's on the same images and weights.

Tiny PARSeq as in tests/test_serve.py (and a tiny CRNN), f32 on the CPU,
weights drawn by the JAX package and carried over by the state_dict
converters. The classifier biases are raised on a few classes, and the
images alternate between dark and bright (a tiny random model reads
uniform noise alike), so PARSeq's reads differ between images, with
confidences that do not underflow; then a swap of two results shows in the
comparison.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parseq_tpu.serve import InferenceServer as JaxInferenceServer
from parseq_tpu.utils import registry as jregistry
from parseq_tpu_torch.cli import serve as serve_cli
from parseq_tpu_torch.serve import InferenceServer
from parseq_tpu_torch.serve import server as serve_lib
from parseq_tpu_torch.utils import registry
from parseq_tpu_torch.utils.convert import state_dict_from_jax

from .test_torch_evaluate import _bias, _crnn_pair

# f32 both sides: the two packages' confidences differ by f32 noise only.
CONF_ATOL = 1e-5
# requests to the local HTTP server go straight to it, whatever proxy the
# environment names
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))
TINY = dict(max_label_length=5, img_size=[16, 32], enc_depth=1, embed_dim=32,
            enc_num_heads=2, dec_num_heads=4)


def _parseq_pair():
    jb = jregistry.create_model('parseq', dtype=jnp.float32, **TINY)
    # EOS (id 0) and 'a', 'b' (ids 11, 12): reads of 0-5 of those letters
    jb.params = _bias(jb.params, 'head', [0, 11, 12], 4.0)
    tb = registry.create_model('parseq', device='cpu', dtype=torch.float32, **TINY)
    tb.module.load_state_dict(state_dict_from_jax(jb.params), strict=True)
    return jb, tb


@pytest.fixture(scope='module')
def pair():
    return _parseq_pair()


@pytest.fixture(scope='module')
def bundle(pair):
    return pair[1]


def _u8(n, size, seed=0):
    return list(np.random.default_rng(seed).integers(0, 256, (n, *size, 3), dtype=np.uint8))


def _levels(n, size, seed=0):
    """n noisy uint8 images about brightness levels from 0 to 255, dark and
    bright in turns."""
    rng = np.random.default_rng(seed)
    levels = np.linspace(0, 255, n)
    order = [levels[i // 2] if i % 2 == 0 else levels[-1 - i // 2] for i in range(n)]
    return [np.clip(rng.normal(v, 30, (*size, 3)), 0, 255).astype(np.uint8) for v in order]


def _serve(server_cls, bundle, images, **kwargs):
    """Submit all images at once to a fresh server; returns the results and
    its stats."""
    srv = server_cls(bundle, **{'max_batch': 8, 'max_wait_ms': 200.0, **kwargs}).start()
    try:
        futures = [srv.submit(im) for im in images]
        return [f.result(timeout=120) for f in futures], dict(srv.stats)
    finally:
        srv.stop()


# -- the cases of tests/test_serve.py ----------------------------------------

def test_rung_ladder():
    assert serve_lib._rungs(32) == [1, 2, 4, 8, 16, 32]
    assert serve_lib._rungs(12) == [1, 2, 4, 8, 12]
    assert serve_lib._rungs(1) == [1]


def test_submit_batch_and_results(bundle):
    srv = InferenceServer(bundle, max_batch=8, max_wait_ms=30.0).start()
    try:
        imgs = [np.random.default_rng(i).uniform(-1, 1, (16, 32, 3)).astype(np.float32)
                for i in range(5)]
        futures = [srv.submit(im) for im in imgs]
        results = [f.result(timeout=120) for f in futures]
        assert len(results) == 5
        for text, conf in results:
            assert isinstance(text, str) and 0.0 <= conf <= 1.0
        # same image twice -> same answer (determinism through the batcher)
        f1 = srv.submit(imgs[0]).result(timeout=60)
        f2 = srv.submit(imgs[0]).result(timeout=60)
        assert f1[0] == f2[0]
        assert srv.stats['requests'] >= 7
        # coalescing actually happened: fewer batches than requests
        assert srv.stats['batches'] < srv.stats['requests']
    finally:
        srv.stop()


def test_results_match_direct_read(bundle):
    srv = InferenceServer(bundle, max_batch=4, max_wait_ms=5.0).start()
    try:
        img = np.random.default_rng(7).uniform(-1, 1, (16, 32, 3)).astype(np.float32)
        direct_labels, direct_conf = bundle.read(img[None])
        text, conf = srv.submit(img).result(timeout=120)
        assert text == direct_labels[0]
        assert abs(conf - direct_conf[0]) < 1e-4
    finally:
        srv.stop()


def _png(pixels):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format='PNG')
    return buf.getvalue()


def test_http_cli_end_to_end(bundle):
    """Full stack: the serve CLI's handler over a live localhost HTTP server,
    the status codes of the JAX CLI, and the read of the JAX CLI's path
    (PIL decode and resize, then uint8 through the server)."""
    from http.server import ThreadingHTTPServer

    from PIL import Image

    from parseq_tpu_torch.data.transforms import preprocess_pil_u8

    srv = InferenceServer(bundle, max_batch=4, max_wait_ms=2.0).start()
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), serve_cli.make_handler(srv, bundle))
    url = f'http://127.0.0.1:{httpd.server_address[1]}'
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with LOCAL.open(f'{url}/healthz') as r:
            health = json.load(r)
        assert health['ok'] is True and set(health['stats']) == {'batches', 'requests', 'padded'}

        pixels = np.random.default_rng(0).integers(0, 255, (20, 50, 3), np.uint8)
        req = urllib.request.Request(f'{url}/v1/read', data=_png(pixels), method='POST')
        with LOCAL.open(req, timeout=120) as r:
            out = json.load(r)
        texts, confs, _ = serve_lib.direct_reads(
            bundle, [preprocess_pil_u8(Image.fromarray(pixels), bundle.img_size)])
        assert out['text'] == texts[0] and abs(out['confidence'] - confs[0]) < CONF_ATOL

        for path, data, code in (('/v1/read', b'not an image', 400), ('/v2/read', b'', 404)):
            req = urllib.request.Request(url + path, data=data, method='POST')
            with pytest.raises(urllib.error.HTTPError) as e:
                LOCAL.open(req, timeout=60)
            assert e.value.code == code
        with pytest.raises(urllib.error.HTTPError) as e:
            LOCAL.open(f'{url}/nothing', timeout=60)
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        t.join(timeout=10)
    assert not t.is_alive()


def test_stop_fails_pending_and_rejects_new(bundle):
    srv = InferenceServer(bundle, max_batch=4, max_wait_ms=1.0).start()
    srv.stop()
    f = srv.submit(np.zeros((16, 32, 3), np.float32))
    with pytest.raises(RuntimeError, match='stopped'):
        f.result(timeout=10)
    assert not any(t.is_alive() for t in [srv._dispatcher, *srv._drainers])


def test_wrong_shape_submission_fails_only_that_request(bundle):
    srv = InferenceServer(bundle, max_batch=4, max_wait_ms=1.0).start()
    try:
        bad = srv.submit(np.zeros((99, 99, 3), np.float32))
        with pytest.raises(Exception):
            bad.result(timeout=60)
        # server still serves well-formed requests afterwards
        good = srv.submit(np.zeros((16, 32, 3), np.float32))
        text, conf = good.result(timeout=60)
        assert isinstance(text, str)
    finally:
        srv.stop()


# -- the port's server against the JAX package's -----------------------------

@pytest.mark.parametrize('family', ['parseq', 'crnn'])
def test_served_reads_match_the_jax_server(family, pair):
    """The same 11 seeded uint8 images through both servers (a batch of 8,
    then 3 padded to the rung of 4): equal strings, confidences within
    CONF_ATOL; and the port's also against its own reads of one image."""
    jb, tb = pair if family == 'parseq' else _crnn_pair()
    images = _levels(11, tb.img_size, seed=3)
    want, _ = _serve(JaxInferenceServer, jb, images)
    got, stats = _serve(InferenceServer, tb, images)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=0,
                               atol=CONF_ATOL)
    assert stats == {'batches': 2, 'requests': 11, 'padded': 1}
    assert min(c for _, c in got) > 1e-4
    if family == 'parseq':  # (a random CRNN reads blanks whatever the image)
        assert len({t for t, _ in got}) > 2
    texts, confs, _ = serve_lib.direct_reads(tb, images)
    assert [t for t, _ in got] == texts
    np.testing.assert_allclose([c for _, c in got], confs, rtol=0, atol=CONF_ATOL)


def test_uint8_and_f32_requests_in_one_batch(pair):
    """A batch with an f32 request normalises its uint8 members on the host,
    with normalize_u8's op order: the same reads as an all-uint8 batch, and
    as the JAX server on the same mixed batch."""
    jb, tb = pair
    u8 = _levels(8, tb.img_size, seed=5)
    mixed = [im if i % 2 else (im.astype(np.float32) / 255.0 - 0.5) / 0.5
             for i, im in enumerate(u8)]
    got, stats = _serve(InferenceServer, tb, mixed)
    assert stats == {'batches': 1, 'requests': 8, 'padded': 0}
    all_u8, _ = _serve(InferenceServer, tb, u8)
    want, _ = _serve(JaxInferenceServer, jb, mixed)
    for other in (all_u8, want):
        assert [t for t, _ in got] == [t for t, _ in other]
        np.testing.assert_allclose([c for _, c in got], [c for _, c in other], rtol=0,
                                   atol=CONF_ATOL)


class _SwappingServer(InferenceServer):
    """The planted fault of chip_smoke.py phase 10: a drain that hands the
    first two requests of a batch each other's results."""

    def _resolve(self, reqs, ids, conf):
        super()._resolve([reqs[1], reqs[0], *reqs[2:]] if len(reqs) > 1 else reqs, ids, conf)


def test_planted_swap_fails_the_check(bundle):
    images = _levels(16, bundle.img_size, seed=9)
    direct = serve_lib.direct_reads(bundle, images)
    served, _ = _serve(InferenceServer, bundle, images)
    ok, wrong, worst = serve_lib.check_served(served, direct)
    assert ok and wrong == 0 and worst <= 1e-5
    swapped, stats = _serve(_SwappingServer, bundle, images)
    assert stats['batches'] >= 1
    ok, wrong, worst = serve_lib.check_served(swapped, direct)
    assert not ok and (wrong > 0 or worst > serve_lib.CHECK_LIMITS['confidence'])


@pytest.mark.parametrize('family', ['parseq', 'crnn'])
def test_read_gaps(family, pair):
    """ModelBundle.read(gaps=True): the reads of read() and each one's
    smallest top-1 - top-2 probability over the steps that decide it
    (through EOS for PARSeq, every position for CTC)."""
    tb = pair[1] if family == 'parseq' else _crnn_pair()[1]
    images = [(im.astype(np.float32) / 255.0 - 0.5) / 0.5
              for im in _levels(6, tb.img_size, seed=11)]
    labels, confs, gaps = tb.read(np.stack(images), gaps=True)
    assert (labels, confs) == tuple(tb.read(np.stack(images)))
    probs = np.sort(torch.softmax(tb(np.stack(images)), -1).cpu().numpy(), -1)
    for text, p, gap in zip(labels, probs, gaps):
        steps = len(p) if family == 'crnn' else min(len(text) + 1, len(p))
        assert gap == pytest.approx(float((p[:steps, -1] - p[:steps, -2]).min()), abs=1e-7)
        assert 0.0 <= gap <= 1.0


def test_a_failing_forward_fails_its_batch_and_serving_goes_on(bundle, monkeypatch):
    """A kernel that fails to build or launch raises in the forward: the
    requests of that batch fail with its error, later ones are served."""
    srv = InferenceServer(bundle, max_batch=4, max_wait_ms=1.0).start()
    try:
        with monkeypatch.context() as m:
            def launch_fails(*args, **kwargs):
                raise RuntimeError('ar_decode kernel launch failed: cuda error 1')

            m.setattr(bundle.module, 'forward', launch_fails)
            with pytest.raises(RuntimeError, match='launch failed'):
                srv.submit(_u8(1, bundle.img_size)[0]).result(timeout=60)
        text, conf = srv.submit(_u8(1, bundle.img_size)[0]).result(timeout=60)
        assert isinstance(text, str) and 0.0 < conf <= 1.0
    finally:
        srv.stop()


def test_read_files(bundle, tmp_path):
    from PIL import Image

    from parseq_tpu_torch.data.transforms import preprocess_pil_u8

    paths, crops = [], []
    for i, pixels in enumerate(_u8(3, (24, 60), seed=13)):
        paths.append(tmp_path / f'{i}.png')
        Image.fromarray(pixels).save(paths[-1])
        crops.append(preprocess_pil_u8(Image.fromarray(pixels), bundle.img_size))
    srv = InferenceServer(bundle, max_batch=4, max_wait_ms=5.0).start()
    try:
        got = srv.read_files(paths)
    finally:
        srv.stop()
    texts, confs, _ = serve_lib.direct_reads(bundle, crops)
    assert [t for t, _ in got] == texts
    np.testing.assert_allclose([c for _, c in got], confs, rtol=0, atol=CONF_ATOL)


def test_serve_cli_needs_a_card_or_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit):
        serve_cli.main(['model.pt'])
    # --int8 quantizes a ViT encoder (ops/quant.py); CRNN has none, and the
    # JAX CLI refuses it alike
    crnn = registry.create_model('crnn', device='cpu', hidden_size=16)
    torch.save(crnn.module.state_dict(), tmp_path / 'crnn.pt')
    with pytest.raises(ValueError, match='ViT'):
        serve_cli.main([str(tmp_path / 'crnn.pt'), '--int8', '--device', 'cpu',
                        'hidden_size:int=16'])
