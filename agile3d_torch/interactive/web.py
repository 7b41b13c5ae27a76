"""Browser front end of the annotation tool (counterpart of the JAX
package's ``interactive/web.py``): a stdlib ThreadingHTTPServer around
``InteractiveSegmentationServer`` and a self-contained WebGL point-cloud
viewer (``viewer.html``: orbit / zoom / pan, number-key object selection,
ctrl-click = background, per-object mask colours). Clicks are picked in
screen space by the page (``interactive/picking.py`` mirrors it).

Endpoints:
  GET  /            viewer page
  GET  /scene       scene meta (name, counts, index, has_labels, mesh)
  GET  /points      binary: [n f32 xyz][n u8 rgb] voxel-level points
  GET  /mesh        binary: [n f32 xyz][n u8 rgb][n u32 voxel row]
                    [f*3 u32 triangles] of a mesh scan (404 otherwise)
  POST /click       {click_idx, click_time_idx} -> binary u8 labels per
                    voxel; X-IoU / X-Latency-Ms response headers
  POST /scene/next  switch scene        POST /scene/prev
"""

from __future__ import annotations

import json
import os
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_HTML_PATH = os.path.join(os.path.dirname(__file__), "viewer.html")


def make_handler(seg_server):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code, body: bytes, ctype="application/json",
                  headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            s = seg_server
            if self.path in ("/", "/index.html"):
                with open(_HTML_PATH, "rb") as f:
                    self._send(200, f.read(), "text/html")
            elif self.path == "/scene":
                faces = s.loader.faces
                meta = {
                    "name": s.sample.scene_name,
                    "index": s.loader.index,
                    "count": len(s.loader),
                    "n_vox": int(s.n_valid),
                    "n_full": int(len(s.loader.coords)),
                    "has_labels": s.loader.labels_full is not None,
                    "max_obj": s.cfg.model.max_fg_objects,
                    "mesh": faces is not None,
                    "n_faces": 0 if faces is None else int(len(faces)),
                }
                self._send(200, json.dumps(meta).encode())
            elif self.path == "/points":
                pts = s.sample.raw_coords.astype(np.float32)
                cols = s.sample.feats
                cols = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
                body = pts.tobytes() + cols.tobytes()
                self._send(200, body, "application/octet-stream",
                           [("X-Count", str(len(pts)))])
            elif self.path == "/mesh":
                # the client renders the triangles, picks a vertex and
                # maps it to its voxel row for clicks and recolouring
                pts = s.loader.coords.astype(np.float32)
                cols = (np.clip(s.loader.colors, 0, 1) * 255).astype(
                    np.uint8)
                inv = s.sample.inverse_map.astype(np.uint32)
                faces = s.loader.faces
                if faces is None:
                    self._send(404, b"{}")
                    return
                body = (pts.tobytes() + cols.tobytes() + inv.tobytes()
                        + faces.astype(np.uint32).tobytes())
                self._send(200, body, "application/octet-stream",
                           [("X-Count", str(len(pts))),
                            ("X-Faces", str(len(faces)))])
            else:
                self._send(404, b"{}")

        def do_POST(self):
            s = seg_server
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/click":
                click_idx = {k: list(map(int, v))
                             for k, v in payload["click_idx"].items()}
                click_time = {k: list(map(int, v))
                              for k, v in payload["click_time_idx"].items()}
                t0 = time.perf_counter()
                pred_vox, _, iou = s.get_next_click(
                    click_idx, click_time, return_voxel=True)
                ms = (time.perf_counter() - t0) * 1e3
                self._send(200, pred_vox.astype(np.uint8).tobytes(),
                           "application/octet-stream",
                           [("X-IoU", "NA" if iou is None else f"{iou:.4f}"),
                            ("X-Latency-Ms", f"{ms:.2f}")])
            elif self.path == "/scene/next":
                name = s.next_scene()
                self._send(200, json.dumps({"name": name}).encode())
            elif self.path == "/scene/prev":
                name = s.previous_scene()
                self._send(200, json.dumps({"name": name}).encode())
            else:
                self._send(404, b"{}")

    return Handler


def serve(seg_server, host="127.0.0.1", port=8008):
    httpd = ThreadingHTTPServer((host, port), make_handler(seg_server))
    print(f"AGILE3D web annotator at http://{host}:{port}/ "
          f"(scene {seg_server.sample.scene_name})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
