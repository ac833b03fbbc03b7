"""Web demo: caption and restore in a browser page (counterpart of
`faithdiff_tpu/serving/web_demo.py`).

The same single page and routes as the JAX demo (standard library
`http.server`): `GET /` serves the page (a caption button, a restore
button, CFG / steps / seed / tile size / overlap / upscale / color-fix /
HDR / start-point controls); `POST /restore` and `POST /caption` take the
upload as base64 in `image` and answer JSON. `main` serves the restore
path of `cli.py restore` on the card: the pipeline of
`cli.load_checkpointed_pipeline`, HDR, LANCZOS upscale, replicate pad, the
pipeline, crop; the reply's PNG is `utils/png.encode_png`'s. Uploads are
PNG or JPEG, decoded by `utils/png.decode_image` as Pillow's
`convert("RGB")` decodes them; one the decoders refuse is answered with
`{"error": ...}` naming the reason.

    python -m faithdiff_tpu_torch.serving.web_demo [--checkpoint_dir C] \
        [--tokenizer_dir SDXL] [--use_fp8] [--use_tile_vae] \
        [--num_inference_steps 20] [--host H] [--port 7860] \
        [--tiny --device cpu]
"""
from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from ..utils.png import decode_image, encode_png

_PAGE = """<!doctype html>
<html><head><title>FaithDiff-TPU demo</title><style>
body{font-family:sans-serif;max-width:900px;margin:2em auto}
label{display:block;margin:.4em 0}
img{max-width:100%%;border:1px solid #ccc}
.row{display:flex;gap:1em}.col{flex:1}
</style></head><body>
<h2>FaithDiff-TPU — diffusion-prior restoration</h2>
<input type=file id=file accept="image/*"><br>
<label>Caption <input id=caption size=80 placeholder="(use Generate Caption or type)"></label>
<button onclick="caption()">Generate Caption</button>
<div class=row><div class=col>
<label>Upscale <input id=upscale type=number value=2 min=1 max=4></label>
<label>Steps <input id=steps type=number value=20 min=1 max=100></label>
<label>CFG <input id=cfg type=number value=5.0 step=0.5></label>
<label>Seed <input id=seed type=number value=42></label>
</div><div class=col>
<label>Tile size <input id=tile type=number value=1024 step=64></label>
<label>Tile overlap <input id=overlap type=number value=0.5 step=0.1></label>
<label>Color fix <select id=colorfix><option>wavelet</option><option>adain</option><option>nofix</option></select></label>
<label>Start point <select id=start><option>lr</option><option>noise</option></select></label>
<label>HDR <input id=hdr type=number value=0 step=0.1 min=0 max=1></label>
</div></div>
<button onclick="restore()">Restoration Run</button> <span id=status></span>
<div class=row><div class=col><h4>Input</h4><img id=inimg></div>
<div class=col><h4>Output</h4><img id=outimg></div></div>
<script>
let b64=null;
file.onchange=()=>{const r=new FileReader();r.onload=()=>{b64=r.result.split(',')[1];inimg.src=r.result};r.readAsDataURL(file.files[0])};
async function post(path,body){const r=await fetch(path,{method:'POST',body:JSON.stringify(body)});return r.json()}
async function caption(){if(!b64)return;status.textContent='captioning...';const o=await post('/caption',{image:b64});document.getElementById('caption').value=o.caption||o.error;status.textContent=''}
async function restore(){if(!b64)return;status.textContent='restoring...';
const o=await post('/restore',{image:b64,caption:caption.value,
upscale:+upscale.value,steps:+steps.value,cfg:+cfg.value,seed:+seed.value,
tile:+tile.value,overlap:+overlap.value,color_fix:colorfix.value,
start_point:start.value,hdr:+hdr.value});
if(o.image){outimg.src='data:image/png;base64,'+o.image}status.textContent=o.error||'done'}
</script></body></html>"""


def _upload(body: dict) -> np.ndarray:
    return decode_image(base64.b64decode(body["image"]), "the uploaded image")


class DemoApp:
    """Holds the restore / caption callables; serve with `serve()`.

    restore_fn(image_u8_hwc, caption, **opts) -> image_u8_hwc
    caption_fn(image_u8_hwc) -> str (optional)
    """

    def __init__(self, restore_fn: Callable,
                 caption_fn: Optional[Callable] = None):
        self.restore_fn = restore_fn
        self.caption_fn = caption_fn

    def handle_restore(self, body: dict) -> dict:
        try:
            img = _upload(body)
        except ValueError as e:          # an image the decoders refuse
            return {"error": str(e)}
        out = self.restore_fn(
            img, body.get("caption", ""),
            upscale=int(body.get("upscale", 2)),
            steps=int(body.get("steps", 20)),
            cfg=float(body.get("cfg", 5.0)),
            seed=int(body.get("seed", 42)),
            tile=int(body.get("tile", 1024)),
            overlap=float(body.get("overlap", 0.5)),
            color_fix=body.get("color_fix", "wavelet"),
            start_point=body.get("start_point", "lr"),
            hdr=float(body.get("hdr", 0.0)),
        )
        return {"image": base64.b64encode(encode_png(np.uint8(out))).decode()}

    def handle_caption(self, body: dict) -> dict:
        if self.caption_fn is None:
            return {"error": "no captioner loaded"}
        try:
            img = _upload(body)
        except ValueError as e:
            return {"error": str(e)}
        return {"caption": self.caption_fn(img)}


def make_handler(app: DemoApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            data = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            try:
                if self.path == "/restore":
                    out = app.handle_restore(body)
                elif self.path == "/caption":
                    out = app.handle_caption(body)
                else:
                    out = {"error": "unknown route"}
            except Exception as e:      # the page shows the request's error
                out = {"error": str(e)}
            data = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    return Handler


def serve(app: DemoApp, host: str = "0.0.0.0",
          port: int = 7860) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    print(f"demo at http://{host}:{port}", flush=True)
    return server


def make_restore_fn(pipe, encode=None) -> Callable:
    """The demo's restore: HDR, LANCZOS upscale, replicate pad to /8, the
    pipeline (zero prompt embeds unless `encode` and a caption), crop back;
    the steps and defaults of the JAX demo's restore and the input of
    `cli.py restore`."""
    import torch

    from ..utils.image import check_image_size, create_hdr_effect
    from ..utils.resample import resize_lanczos

    ucfg = pipe.unet.config
    zero_embeds = (torch.zeros((1, 77, ucfg.cross_attention_dim)),
                   torch.zeros((1, ucfg.projection_class_embeddings_input_dim
                                - 6 * ucfg.addition_time_embed_dim)))

    def restore_fn(img_u8, caption, **opts):
        if opts.get("hdr", 0.0) > 0:
            img_u8 = create_hdr_effect(img_u8, opts["hdr"], device=pipe.device)
        up = int(opts.get("upscale", 2))
        h, w = img_u8.shape[:2]
        img_u8 = resize_lanczos(img_u8, (w * up, h * up))
        padded, w0, h0, _, _ = check_image_size(img_u8)
        if caption and encode is not None:
            pe, pooled = encode(caption)
        else:
            pe, pooled = zero_embeds
        # the padded uint8 image, as `cli.py restore` hands it over (the
        # JAX demo divides by 255 on the host first; the pipeline's own
        # division on the card rounds otherwise, so its PNG would not be
        # the CLI's byte for byte)
        out = pipe(padded, pe, pooled, output_type="uint8",
                   num_inference_steps=int(opts.get("steps", 20)),
                   guidance_scale=float(opts.get("cfg", 5.0)),
                   seed=int(opts.get("seed", 42)),
                   overlap=float(opts.get("overlap", 0.5)),
                   color_fix=opts.get("color_fix", "wavelet"),
                   start_point=opts.get("start_point", "lr"))
        return out[:h0, :w0]

    return restore_fn


def main(argv=None):
    """The demo over the restore pipeline of a converted checkpoint (the
    JAX demo's flags, plus `--device`; `--tiny` for a smoke run)."""
    import argparse
    import time as _time
    import types

    p = argparse.ArgumentParser("faithdiff-web-demo")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--use_fp8", action="store_true")
    p.add_argument("--use_tile_vae", action="store_true")
    p.add_argument("--num_inference_steps", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device the pipeline runs on")
    a = p.parse_args(argv)

    from ..cli import load_checkpointed_pipeline, make_text_encoder

    pargs = types.SimpleNamespace(
        num_inference_steps=a.num_inference_steps, guidance_scale=5.0,
        latent_tiled_size=1024, latent_tiled_overlap=0.5,
        start_point="lr", color_fix="wavelet",
        use_tile_vae=a.use_tile_vae, use_fp8=a.use_fp8, tiny=a.tiny,
        checkpoint_dir=a.checkpoint_dir, tokenizer_dir=a.tokenizer_dir,
        device=a.device)
    pipe = load_checkpointed_pipeline(pargs)
    server = serve(DemoApp(make_restore_fn(pipe, make_text_encoder(pargs))),
                   a.host, a.port)
    try:
        while True:
            _time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
