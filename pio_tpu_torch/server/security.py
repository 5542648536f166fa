"""TLS configuration for the HTTP servers.

Parity with the reference's SSL stack (common/.../configuration/
SSLConfiguration.scala:10-60: JKS keystore -> spray ServerSSLEngineProvider,
used by the deploy server at CreateServer.scala:316-321) — here a PEM
cert/key pair -> ssl.SSLContext, shared by the deploy/event/admin/dashboard
servers. Config resolution order mirrors the reference's server.conf:
explicit arguments, then PIO_TPU_SERVER_{CERT,KEY} env vars.

`generate_self_signed` shells out to the system openssl to mint a dev/test
certificate (the reference ships a pre-built conf/keystore.jks for the same
purpose).
"""

from __future__ import annotations

import os
import ssl
import subprocess


class TLSConfigError(RuntimeError):
    pass


def resolve_cert_paths(
    certfile: str | None = None, keyfile: str | None = None
) -> tuple[str, str] | None:
    """(cert, key) from args or PIO_TPU_SERVER_{CERT,KEY}; None = no TLS."""
    certfile = certfile or os.environ.get("PIO_TPU_SERVER_CERT")
    keyfile = keyfile or os.environ.get("PIO_TPU_SERVER_KEY_FILE")
    if not certfile and not keyfile:
        return None
    if not (certfile and keyfile):
        raise TLSConfigError(
            "TLS needs both a certificate and a key "
            "(--cert/--key or PIO_TPU_SERVER_CERT/PIO_TPU_SERVER_KEY_FILE)"
        )
    for p in (certfile, keyfile):
        if not os.path.exists(p):
            raise TLSConfigError(f"TLS file not found: {p}")
    return certfile, keyfile


def ssl_context_from(
    certfile: str, keyfile: str, password: str | None = None
) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile, password=password)
    return ctx


def server_ssl_context(
    certfile: str | None = None, keyfile: str | None = None
) -> ssl.SSLContext | None:
    """Resolve config and build a server context; None when TLS is off."""
    paths = resolve_cert_paths(certfile, keyfile)
    if paths is None:
        return None
    return ssl_context_from(*paths)


def generate_self_signed(
    out_dir: str, common_name: str = "localhost", days: int = 365
) -> tuple[str, str]:
    """Mint a self-signed cert with the system openssl; returns (cert, key)
    paths. Dev/test convenience only — production should bring real certs."""
    os.makedirs(out_dir, exist_ok=True)
    cert = os.path.join(out_dir, "server.crt")
    key = os.path.join(out_dir, "server.key")
    proc = subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", key, "-out", cert, "-days", str(days),
            "-nodes", "-subj", f"/CN={common_name}",
            "-addext", f"subjectAltName=DNS:{common_name},IP:127.0.0.1",
        ],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise TLSConfigError(f"openssl failed: {proc.stderr}")
    return cert, key
