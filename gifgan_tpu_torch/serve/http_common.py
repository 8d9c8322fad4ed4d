"""Shared hardening for the stdlib HTTP services (explorer/webcam/survey).

The reference exposed its demo services with no request-size limits and no
transport security (explorer.py served plain bottle; the webcam demo's only
protection was that scp/ssh carried the payloads, webcam_client.py:229-247).
These helpers give the stdlib replacements:

- a request-size cap: bodies larger than the per-service limit are refused
  with 413 BEFORE the payload is read, so an oversized POST costs the
  server a header parse, not bandwidth or memory;
- optional in-process TLS (``tls_cert``/``tls_key`` on every ``serve()``),
  so the services can face a network without a mandatory front proxy.
  A self-signed pair for testing:

      openssl req -x509 -newkey rsa:2048 -nodes -days 1 \
          -subj /CN=localhost -keyout key.pem -out cert.pem

  For production, terminating at a front proxy (nginx/caddy) is equally
  supported — the services are plain HTTP behind it; keep the bearer token
  either way, TLS protects the transport, the token gates the compute.
"""

import json
import ssl
import threading
from http.server import ThreadingHTTPServer
from typing import Optional

# Explorer/survey requests are small HTML-form / JSON payloads.
MAX_FORM_BODY = 64 * 1024
# Webcam /animate accepts one PNG frame; 8 MiB covers any real camera still
# (the server resizes to model resolution anyway).
MAX_IMAGE_BODY = 8 * 1024 * 1024


def reject(handler, code: int, msg: str) -> None:
    """Answer a request with a JSON error and no further reads."""
    body = json.dumps({"response": "error", "msg": msg}).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def body_length(handler, max_bytes: int) -> Optional[int]:
    """Validated Content-Length of the pending request body.

    Returns the length, or None after answering the request itself:
    413 when the declared length exceeds ``max_bytes`` (the body is never
    read), 400 when the header is malformed. Callers must ``return`` when
    they get None back.
    """
    raw = handler.headers.get("Content-Length") or "0"
    try:
        n = int(raw)
    except ValueError:
        reject(handler, 400, f"bad Content-Length {raw!r}")
        return None
    if n < 0:
        reject(handler, 400, f"bad Content-Length {raw!r}")
        return None
    if n > max_bytes:
        reject(handler, 413, f"body of {n} bytes exceeds the "
                             f"{max_bytes}-byte limit")
        return None
    return n


def make_server(host: str, port: int, handler_cls, background: bool = False,
                tls_cert: Optional[str] = None,
                tls_key: Optional[str] = None):
    """ThreadingHTTPServer with optional TLS; the shared tail of every
    ``serve()`` in this package. With ``background=True`` the server runs in
    a daemon thread and is returned; otherwise this blocks."""
    server = ThreadingHTTPServer((host, port), handler_cls)
    if tls_cert:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(tls_cert, tls_key)
        server.socket = ctx.wrap_socket(server.socket, server_side=True)
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    server.serve_forever()
