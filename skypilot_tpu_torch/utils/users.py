"""The replica's reads of the users table: bearer tokens, the scrape
token, and the QoS tenant behind a token.

Port copy of the part of the framework-free ``skypilot_tpu/users``
package that a serving replica calls (``bearer_token``,
``metrics_scrape_allowed``, ``authenticate`` and ``tenant_from_token``),
held to it by ``tests/test_torch_qos.py``. It reads the same sqlite
table (``$SKYTPU_STATE_DIR/users.db``) and writes no user.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import sqlite3
import time
from typing import Any, Dict, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
    name TEXT PRIMARY KEY,
    token_hash TEXT NOT NULL,
    role TEXT NOT NULL,
    created_at REAL
);
"""


def _db_path() -> str:
    d = os.path.expanduser(
        os.environ.get('SKYTPU_STATE_DIR', '~/.skypilot_tpu'))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, 'users.db')


def _conn() -> sqlite3.Connection:
    conn = sqlite3.connect(_db_path(), timeout=10)
    conn.row_factory = sqlite3.Row
    conn.executescript(_SCHEMA)
    return conn


def _hash(token: str) -> str:
    return hashlib.sha256(token.encode()).hexdigest()


def bearer_token(headers: Any) -> Optional[str]:
    """The request's bearer token; None when absent or not encodable as
    UTF-8 (such a token can match no stored one)."""
    supplied = headers.get('Authorization', '') or ''
    if not supplied.startswith('Bearer '):
        return None
    token = supplied[len('Bearer '):]
    try:
        token.encode('utf-8')
    except UnicodeEncodeError:
        return None
    return token


def metrics_scrape_allowed(headers: Any) -> bool:
    """The ``SKYTPU_METRICS_TOKEN`` gate of ``/metrics`` and ``/debug/*``:
    unset = open; set = the bearer must equal it (a timing-safe
    compare)."""
    scrape_token = os.environ.get('SKYTPU_METRICS_TOKEN')
    if not scrape_token:
        return True
    token = bearer_token(headers) or ''
    return hmac.compare_digest(token.encode('utf-8'),
                               scrape_token.encode('utf-8'))


def authenticate(token: Optional[str]) -> Optional[Dict[str, str]]:
    """token -> {'name', 'role'}, or None. With no users registered and
    no ``SKYTPU_API_TOKEN``, every caller is the implicit local admin."""
    root = os.environ.get('SKYTPU_API_TOKEN')
    with _conn() as conn:
        registered = conn.execute('SELECT 1 FROM users LIMIT 1').fetchone()
    if registered is None and not root:
        return {'name': os.environ.get('USER', 'local'), 'role': 'admin'}
    if token is None:
        return None
    if root and hmac.compare_digest(_hash(token), _hash(root)) \
            and token == root:
        return {'name': 'root', 'role': 'admin'}
    with _conn() as conn:
        row = conn.execute(
            'SELECT name, role FROM users WHERE token_hash = ?',
            (_hash(token),)).fetchone()
    return {'name': row['name'], 'role': row['role']} if row else None


_TENANT_CACHE: Dict[str, Any] = {}
_TENANT_CACHE_TTL_S = 30.0


def tenant_from_token(token: str) -> Optional[str]:
    """The QoS tenant of a bearer token: its user's name, or None. Cached
    for 30 s, so admission pays no sqlite read per request (a revoked
    token lingers that long)."""
    now = time.time()
    hit = _TENANT_CACHE.get(token)
    if hit is not None and now - hit[0] < _TENANT_CACHE_TTL_S:
        return hit[1]
    user = authenticate(token)
    name = user['name'] if user else None
    if len(_TENANT_CACHE) >= 1024:  # abuse bound
        _TENANT_CACHE.clear()
    _TENANT_CACHE[token] = (now, name)
    return name
