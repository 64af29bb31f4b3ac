"""Authentication and authorization.

Behavioral parity with the reference's auth stack:
- request authenticators: basic auth + bearer token
  (plugin/pkg/auth/authenticator/{password/passwordfile,token/tokenfile},
  pkg/apiserver/authn.go:35)
- service-account JWTs (pkg/serviceaccount/jwt.go) — the reference signs
  RS256 with the cluster key; we sign HS256 (HMAC-SHA256) with a cluster
  secret since there is no bundled RSA implementation. Claims mirror the
  reference: iss, sub, and the kubernetes.io/serviceaccount/* set.
- ABAC authorizer from a policy file of one-JSON-object-per-line
  (pkg/auth/authorizer/abac/abac.go), with the same matching rules:
  empty/'*' fields match everything, a '*' user matches all users.

Users and groups: pkg/auth/user/user.go.

A copy of `kubernetes_tpu/server/auth.py` (basic, token, x509 CN,
service-account tokens, ABAC).
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class UserInfo:
    """pkg/auth/user/user.go DefaultInfo."""

    name: str
    uid: str = ""
    groups: Tuple[str, ...] = ()


class AuthenticationError(Exception):
    """Surfaces as HTTP 401."""


# -- authenticators (pkg/apiserver/authn.go) --------------------------------


class PasswordAuthenticator:
    """Basic auth against an in-memory map or a CSV file of
    password,username,uid lines (passwordfile.go)."""

    def __init__(self, users: Optional[Dict[str, Tuple[str, UserInfo]]] = None):
        # username -> (password, UserInfo)
        self.users = users or {}

    @classmethod
    def from_file(cls, path: str) -> "PasswordAuthenticator":
        users: Dict[str, Tuple[str, UserInfo]] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                if len(parts) < 3:
                    raise ValueError(f"malformed password file line: {line!r}")
                password, name, uid = parts[0], parts[1], parts[2]
                users[name] = (password, UserInfo(name=name, uid=uid))
        return cls(users)

    def authenticate_password(self, username: str, password: str) -> UserInfo:
        entry = self.users.get(username)
        if entry is None or not hmac.compare_digest(
            entry[0].encode(), password.encode()
        ):
            raise AuthenticationError("invalid username/password")
        return entry[1]


class TokenAuthenticator:
    """Bearer tokens from a CSV file of token,username,uid[,groups]
    lines (tokenfile.go)."""

    def __init__(self, tokens: Optional[Dict[str, UserInfo]] = None):
        self.tokens = tokens or {}

    @classmethod
    def from_file(cls, path: str) -> "TokenAuthenticator":
        tokens: Dict[str, UserInfo] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                if len(parts) < 3:
                    raise ValueError(f"malformed token file line: {line!r}")
                token, name, uid = parts[0], parts[1], parts[2]
                groups = tuple(g for g in parts[3:] if g)
                tokens[token] = UserInfo(name=name, uid=uid, groups=groups)
        return cls(tokens)

    def authenticate_token(self, token: str) -> UserInfo:
        info = self.tokens.get(token)
        if info is None:
            raise AuthenticationError("invalid bearer token")
        return info


# -- service-account JWTs (pkg/serviceaccount/jwt.go) -----------------------

ISSUER = "kubernetes-tpu/serviceaccount"
_SA_CLAIM_PREFIX = "kubernetes.io/serviceaccount/"
SERVICE_ACCOUNT_USERNAME_PREFIX = "system:serviceaccount:"


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


class ServiceAccountTokenManager:
    """Mint and verify service-account JWTs (HS256)."""

    def __init__(self, signing_key: bytes):
        self.key = signing_key

    def mint(
        self, namespace: str, name: str, uid: str = "", secret_name: str = ""
    ) -> str:
        header = {"alg": "HS256", "typ": "JWT"}
        claims = {
            "iss": ISSUER,
            "sub": f"{SERVICE_ACCOUNT_USERNAME_PREFIX}{namespace}:{name}",
            _SA_CLAIM_PREFIX + "namespace": namespace,
            _SA_CLAIM_PREFIX + "service-account.name": name,
            _SA_CLAIM_PREFIX + "service-account.uid": uid,
            _SA_CLAIM_PREFIX + "secret.name": secret_name,
        }
        signing_input = f"{_b64url(json.dumps(header).encode())}.{_b64url(json.dumps(claims).encode())}"
        sig = hmac.new(self.key, signing_input.encode(), hashlib.sha256).digest()
        return f"{signing_input}.{_b64url(sig)}"

    def authenticate_token(self, token: str) -> UserInfo:
        try:
            header_b64, claims_b64, sig_b64 = token.split(".")
            signing_input = f"{header_b64}.{claims_b64}".encode()
            expected = hmac.new(self.key, signing_input, hashlib.sha256).digest()
            if not hmac.compare_digest(expected, _b64url_decode(sig_b64)):
                raise AuthenticationError("invalid token signature")
            claims = json.loads(_b64url_decode(claims_b64))
        except (ValueError, binascii.Error, json.JSONDecodeError):
            raise AuthenticationError("malformed service account token")
        if claims.get("iss") != ISSUER:
            raise AuthenticationError("unrecognized token issuer")
        ns = claims.get(_SA_CLAIM_PREFIX + "namespace", "")
        name = claims.get(_SA_CLAIM_PREFIX + "service-account.name", "")
        if not ns or not name:
            raise AuthenticationError("token missing service account claims")
        return UserInfo(
            name=f"{SERVICE_ACCOUNT_USERNAME_PREFIX}{ns}:{name}",
            uid=claims.get(_SA_CLAIM_PREFIX + "service-account.uid", ""),
            groups=("system:serviceaccounts", f"system:serviceaccounts:{ns}"),
        )


class X509Authenticator:
    """Client-certificate authentication: a TLS peer certificate's
    Subject CommonName is the username and its Organization values are
    the groups — the reference's x509 request authenticator with the
    CommonNameUserConversion (pkg/apiserver/authn.go:35,
    plugin/pkg/auth/authenticator/request/x509/x509.go). Chain
    verification against --client-ca-file happens in the TLS handshake
    (ssl.CERT_OPTIONAL); by the time a peer cert reaches this class it
    is already CA-verified."""

    def authenticate_peer_cert(self, peercert: dict) -> UserInfo:
        """`peercert` is ssl.SSLSocket.getpeercert()'s dict form."""
        if not peercert:
            raise AuthenticationError("no client certificate presented")
        name = ""
        groups: List[str] = []
        for rdn in peercert.get("subject", ()):
            for key, value in rdn:
                if key == "commonName" and not name:
                    name = value
                elif key == "organizationName":
                    groups.append(value)
        if not name:
            raise AuthenticationError("client certificate has no CommonName")
        return UserInfo(name=name, groups=tuple(groups))


class UnionAuthenticator:
    """Try each authenticator in order (union.go)."""

    def __init__(
        self,
        password: Optional[PasswordAuthenticator] = None,
        tokens: Optional[List] = None,
    ):
        self.password = password
        self.tokens = tokens or []

    def authenticate_request(self, authorization_header: str) -> UserInfo:
        """Parse an Authorization header (Basic or Bearer)."""
        if not authorization_header:
            raise AuthenticationError("no credentials provided")
        scheme, _, rest = authorization_header.partition(" ")
        scheme = scheme.lower()
        if scheme == "basic" and self.password is not None:
            try:
                decoded = base64.b64decode(rest.strip()).decode()
                username, _, password = decoded.partition(":")
            except (binascii.Error, UnicodeDecodeError):
                raise AuthenticationError("malformed basic auth header")
            return self.password.authenticate_password(username, password)
        if scheme == "bearer":
            token = rest.strip()
            last_err: Optional[AuthenticationError] = None
            for t in self.tokens:
                try:
                    return t.authenticate_token(token)
                except AuthenticationError as e:
                    last_err = e
            raise last_err or AuthenticationError("no token authenticator")
        raise AuthenticationError(f"unsupported authorization scheme {scheme!r}")


# -- ABAC authorizer (pkg/auth/authorizer/abac/abac.go) ---------------------


class AuthorizationError(Exception):
    """Surfaces as HTTP 403."""


@dataclass
class AuthzAttributes:
    """pkg/auth/authorizer/interfaces.go Attributes."""

    user: UserInfo
    readonly: bool = False
    resource: str = ""
    namespace: str = ""


@dataclass
class Policy:
    """One ABAC policy line. Empty fields match everything."""

    user: str = ""
    group: str = ""
    readonly: bool = False  # True limits to read-only verbs
    resource: str = ""
    namespace: str = ""

    def matches(self, a: AuthzAttributes) -> bool:
        if self.user and self.user != "*" and self.user != a.user.name:
            return False
        if self.group and self.group != "*" and self.group not in a.user.groups:
            return False
        if self.readonly and not a.readonly:
            return False
        if self.resource and self.resource != "*" and self.resource != a.resource:
            return False
        if (
            self.namespace
            and self.namespace != "*"
            and self.namespace != a.namespace
        ):
            return False
        return True


class ABACAuthorizer:
    """Policy-list authorizer; any matching line allows."""

    def __init__(self, policies: List[Policy]):
        self.policies = policies

    @classmethod
    def from_file(cls, path: str) -> "ABACAuthorizer":
        policies: List[Policy] = []
        with open(path) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    raw = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(f"{path}:{i}: invalid policy JSON: {e}")
                policies.append(
                    Policy(
                        user=raw.get("user", ""),
                        group=raw.get("group", ""),
                        readonly=bool(raw.get("readonly", False)),
                        resource=raw.get("resource", ""),
                        namespace=raw.get("namespace", ""),
                    )
                )
        return cls(policies)

    def authorize(self, attrs: AuthzAttributes) -> None:
        for p in self.policies:
            if p.matches(attrs):
                return
        raise AuthorizationError(
            f"user {attrs.user.name!r} is not allowed to "
            f"{'read' if attrs.readonly else 'write'} {attrs.resource or '*'}"
            + (f" in {attrs.namespace}" if attrs.namespace else "")
        )


class AlwaysAllowAuthorizer:
    def authorize(self, attrs: AuthzAttributes) -> None:
        return None


class AlwaysDenyAuthorizer:
    def authorize(self, attrs: AuthzAttributes) -> None:
        raise AuthorizationError("always deny")
