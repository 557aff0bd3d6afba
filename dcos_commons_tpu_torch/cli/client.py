"""HTTP client for the scheduler API.

Reference: cli/client/client.go — thin wrapper adding the service URL
prefix and surfacing non-2xx responses as errors with the body text.

Port of ``dcos_commons_tpu/cli/client.py``, line for line but the imports.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Optional
from urllib.parse import urlencode


class CliError(Exception):
    def __init__(self, code: int, body: Any):
        self.code = code
        self.body = body
        super().__init__(f"HTTP {code}: {body}")


class ApiClient:
    def __init__(self, base_url: str, timeout_s: float = 10.0,
                 auth_token: str = "", ca_file: str = ""):
        from dcos_commons_tpu_torch.security import auth as _auth

        self._base = base_url.rstrip("/")
        self._timeout = timeout_s
        self._headers = _auth.auth_headers(auth_token)
        self._ssl_ctx = (
            _auth.client_ssl_context(ca_file)
            if self._base.startswith("https") else None
        )

    def get(self, path: str) -> Any:
        return self._request("GET", path)

    def post(self, path: str, params: Optional[dict] = None,
             body: Optional[Any] = None) -> Any:
        if params:
            clean = {k: v for k, v in params.items() if v is not None}
            if clean:
                path = f"{path}?{urlencode(clean, doseq=True)}"
        return self._request("POST", path, body=body)

    def _request(self, method: str, path: str,
                 body: Optional[Any] = None) -> Any:
        if body is not None:
            data = json.dumps(body).encode("utf-8")
        else:
            data = b"" if method == "POST" else None
        request = urllib.request.Request(
            self._base + path, method=method, data=data,
            headers=dict(self._headers),
        )
        if body is not None:
            request.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(
                request, timeout=self._timeout, context=self._ssl_ctx
            ) as resp:
                code, raw = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            code, raw = e.code, e.read()
        except urllib.error.URLError as e:
            raise CliError(0, f"cannot reach scheduler at {self._base}: {e}")
        body = raw.decode("utf-8", errors="replace")
        try:
            body = json.loads(body)
        except json.JSONDecodeError:
            pass
        if code >= 400:
            raise CliError(code, body)
        return body
