"""Self-signed serving certificate generation.

Parity with the reference's SecureServingOptions self-signed path
(options.go:103-110: MaybeDefaultWithSelfSignedCerts for the
``cedar-authorizer`` public address with 127.0.0.1 as an alternate IP),
using the cryptography library. Existing cert/key pairs are reused.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import pathlib
from typing import Tuple

PAIR_NAME = "cedar-authorizer-server"
PUBLIC_ADDRESS = "cedar-authorizer"


def maybe_self_signed_certs(
    cert_dir: str,
    public_address: str = PUBLIC_ADDRESS,
    alternate_ips: Tuple[str, ...] = ("127.0.0.1",),
    pair_name: str = PAIR_NAME,
) -> Tuple[str, str]:
    """Return (cert_path, key_path), generating a self-signed pair under
    ``cert_dir`` if absent."""
    d = pathlib.Path(cert_dir)
    d.mkdir(parents=True, exist_ok=True)
    cert_path = d / f"{pair_name}.crt"
    key_path = d / f"{pair_name}.key"
    if cert_path.exists() and key_path.exists():
        return str(cert_path), str(key_path)

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, f"{public_address}@self-signed")]
    )
    san = x509.SubjectAlternativeName(
        [x509.DNSName(public_address)]
        + [x509.IPAddress(ipaddress.ip_address(ip)) for ip in alternate_ips]
    )
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(san, critical=False)
        .add_extension(
            x509.BasicConstraints(ca=True, path_length=None), critical=True
        )
        .sign(key, hashes.SHA256())
    )

    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )
    # 0600 from creation: chmod-after-write would leave a world-readable
    # window under the default umask
    fd = os.open(str(key_path), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(key_pem)
    cert_path.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    return str(cert_path), str(key_path)
