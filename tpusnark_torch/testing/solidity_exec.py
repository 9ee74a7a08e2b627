"""Execute the exported Solidity verifier contracts.

The reference ships an on-chain check tier (`gnark/test/
assert_solidity.go:52`: compile the exported contract, run `verifyProof`
on a simulated EVM, assert success and tampered-proof reverts). This image
has no solc and no EVM, so this module provides the equivalent execution
layer: a tokenizer + recursive-descent parser + interpreter for the exact
Solidity subset the two exporters emit (backend/groth16/solidity.py,
backend/plonk/solidity.py), with faithful models of the precompiles the
contracts staticcall:

    0x05 modexp, 0x06 ecAdd, 0x07 ecMul, 0x08 ecPairing (EIP-196/197
    operand layouts, including G2 imaginary-first encoding, point
    validation and subgroup checks — invalid input => staticcall ok=false)

and of `sha256(abi.encodePacked(...))` (strings as ASCII, uint256 as
32-byte big-endian, bytes32 raw, fixed arrays element-wise).

Scope is the emitted dialect, not general Solidity: uint256/bytes32/bool
locals, fixed-size memory/calldata arrays, tuple returns, for/if/revert,
block scopes, and single-staticcall assembly blocks. `verifyProof` runs
with real calldata word lists and raises ContractRevert exactly where the
contract reverts.

The port's copy of tpusnark/testing/solidity_exec.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

import hashlib
import re


class ContractRevert(Exception):
    pass


# ------------------------------------------------------------------ lexer
_TOKEN = re.compile(
    r"""
    (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<string>"[^"]*")
  | (?P<hexnum>0x[0-9a-fA-F]+)
  | (?P<num>\d+)
  | (?P<name>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<punct>:=|\|\||&&|==|!=|<=|>=|\+\+|--|[{}()\[\];,.=<>!+\-*/%&|^~?:])
  | (?P<ws>\s+)
""",
    re.X | re.S,
)


def tokenize(src: str):
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if not m:
            raise SyntaxError(f"lex error at {src[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("comment", "ws"):
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


class _Stream:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self, k=0):
        return self.toks[self.i + k]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, val):
        if self.toks[self.i][1] == val:
            self.i += 1
            return True
        return False

    def expect(self, val):
        t = self.next()
        if t[1] != val:
            raise SyntaxError(f"expected {val!r}, got {t[1]!r} (#{self.i})")
        return t


_TYPES = {"uint256", "bytes32", "bool", "bytes"}


def _is_type(s: _Stream):
    return s.peek()[1] in _TYPES


# ----------------------------------------------------------------- parser
# AST: tuples ('kind', ...)
def _parse_type(s: _Stream):
    base = s.next()[1]
    size = None
    if s.accept("["):
        t = s.peek()
        if t[1] != "]":
            size = int(s.next()[1], 0)
        s.expect("]")
    # location qualifiers
    while s.peek()[1] in ("memory", "calldata", "storage"):
        s.next()
    return base, size


def parse_contract(src: str):
    s = _Stream(tokenize(src))
    consts: dict = {}
    funcs: dict = {}
    # skip to `contract X {`
    while s.peek()[1] != "contract":
        s.next()
    s.next()
    s.next()  # name
    s.expect("{")
    depth = 1
    while True:
        t = s.peek()
        if t[1] == "}" and depth == 1:
            break
        if t[1] in ("uint256", "bytes32"):
            # constant decl: TYPE private constant NAME = value;
            s.next()
            while s.peek()[1] in ("private", "internal", "public", "constant"):
                s.next()
            name = s.next()[1]
            s.expect("=")
            v = s.next()
            consts[name] = int(v[1], 0)
            s.expect(";")
        elif t[1] == "error":
            s.next()
            s.next()  # name
            s.expect("(")
            s.expect(")")
            s.expect(";")
        elif t[1] == "function":
            name, fn = _parse_function(s)
            funcs[name] = fn
        else:
            s.next()
    return consts, funcs


def _parse_function(s: _Stream):
    s.expect("function")
    name = s.next()[1]
    s.expect("(")
    params = []
    while not s.accept(")"):
        _parse_type(s)
        params.append(s.next()[1])
        s.accept(",")
    rets = []
    while s.peek()[1] != "{":
        if s.peek()[1] == "returns":
            s.next()
            s.expect("(")
            while not s.accept(")"):
                _parse_type(s)
                if s.peek()[1] not in (",", ")"):
                    rets.append(s.next()[1])
                else:
                    rets.append(None)
                s.accept(",")
        else:
            s.next()  # visibility / mutability
    body = _parse_block(s)
    return name, {"params": params, "rets": rets, "body": body}


def _parse_block(s: _Stream):
    s.expect("{")
    stmts = []
    while not s.accept("}"):
        stmts.append(_parse_stmt(s))
    return ("block", stmts)


def _parse_stmt(s: _Stream):
    t = s.peek()
    if t[1] == "{":
        return _parse_block(s)
    if t[1] == "if":
        s.next()
        s.expect("(")
        cond = _parse_expr(s)
        s.expect(")")
        then = _parse_stmt(s)
        els = None
        if s.accept("else"):
            els = _parse_stmt(s)
        return ("if", cond, then, els)
    if t[1] == "for":
        s.next()
        s.expect("(")
        init = _parse_stmt(s)  # consumes its ';'
        cond = _parse_expr(s)
        s.expect(";")
        # post: `i++` or assignment without ';'
        post_name = s.next()[1]
        if s.peek()[1] == "++":
            s.next()
            post = ("assign", ("name", post_name), ("bin", "+", ("name", post_name), ("num", 1)))
        else:
            s.expect("=")
            post = ("assign", ("name", post_name), _parse_expr(s))
        s.expect(")")
        body = _parse_stmt(s)
        return ("for", init, cond, post, body)
    if t[1] == "return":
        s.next()
        if s.peek()[1] == ";":
            s.next()
            return ("return", None)
        e = _parse_expr(s)
        s.expect(";")
        return ("return", e)
    if t[1] == "revert":
        s.next()
        err = s.next()[1]
        s.expect("(")
        s.expect(")")
        s.expect(";")
        return ("revert", err)
    if t[1] == "assembly":
        s.next()
        if s.peek()[1] == "(":
            s.expect("(")
            s.next()  # "memory-safe"
            s.expect(")")
        s.expect("{")
        # the only emitted form: ok := staticcall(gas(), N, in, insz, out, outsz)
        target = s.next()[1]
        s.expect(":=")
        s.expect("staticcall")
        s.expect("(")
        args = []
        while not s.accept(")"):
            args.append(_parse_expr(s))
            s.accept(",")
        s.expect("}")
        return ("staticcall", target, args)
    if _is_type(s):
        # declaration (possibly tuple via '(') — single decl here
        _base, size = _parse_type(s)
        name = s.next()[1]
        if s.accept("="):
            e = _parse_expr(s)
            s.expect(";")
            return ("decl", name, e)
        s.expect(";")
        # bare fixed-array decl: zero-initialized memory array
        return ("decl", name, ("array", [("num", 0)] * size) if size else None)
    if t[1] == "(":
        # tuple declaration/assignment: (uint256 a, uint256 b) = expr;
        s.next()
        names = []
        while not s.accept(")"):
            if _is_type(s):
                _parse_type(s)
            names.append(s.next()[1])
            s.accept(",")
        s.expect("=")
        e = _parse_expr(s)
        s.expect(";")
        return ("tupleassign", names, e)
    # assignment or bare expression
    lv = _parse_expr(s)
    if s.accept("="):
        e = _parse_expr(s)
        s.expect(";")
        return ("assign", lv, e)
    s.expect(";")
    return ("expr", lv)


def _parse_expr(s: _Stream):
    e = _parse_or(s)
    if s.peek()[1] == "?":  # ternary (right-associative)
        s.next()
        then = _parse_expr(s)
        s.expect(":")
        els = _parse_expr(s)
        return ("ternary", e, then, els)
    return e


def _bin_level(s, sub, ops):
    e = sub(s)
    while s.peek()[1] in ops:
        op = s.next()[1]
        e = ("bin", op, e, sub(s))
    return e


def _parse_or(s):
    return _bin_level(s, _parse_and, ("||",))


def _parse_and(s):
    return _bin_level(s, _parse_cmp, ("&&",))


def _parse_cmp(s):
    return _bin_level(s, _parse_add, ("==", "!=", "<", ">", "<=", ">="))


def _parse_add(s):
    return _bin_level(s, _parse_mul, ("+", "-"))


def _parse_mul(s):
    return _bin_level(s, _parse_unary, ("*", "/", "%"))


def _parse_unary(s):
    if s.peek()[1] == "!":
        s.next()
        return ("not", _parse_unary(s))
    if s.peek()[1] == "-":
        s.next()
        return ("neg", _parse_unary(s))
    return _parse_postfix(s)


def _parse_postfix(s):
    e = _parse_atom(s)
    while True:
        if s.accept("["):
            idx = _parse_expr(s)
            s.expect("]")
            e = ("index", e, idx)
        elif s.accept("."):
            attr = s.next()[1]
            if s.accept("("):
                args = []
                while not s.accept(")"):
                    args.append(_parse_expr(s))
                    s.accept(",")
                e = ("methodcall", e, attr, args)
            else:
                e = ("attr", e, attr)
        elif s.peek()[1] == "(" and e[0] == "name":
            s.next()
            args = []
            while not s.accept(")"):
                args.append(_parse_expr(s))
                s.accept(",")
            e = ("call", e[1], args)
        else:
            return e


def _parse_atom(s):
    kind, val = s.peek()
    if val == "(":
        s.next()
        items = [_parse_expr(s)]
        while s.accept(","):
            items.append(_parse_expr(s))
        s.expect(")")
        return items[0] if len(items) == 1 else ("tuple", items)
    if val == "[":
        s.next()
        items = []
        while not s.accept("]"):
            items.append(_parse_expr(s))
            s.accept(",")
        return ("array", items)
    if kind == "num" or kind == "hexnum":
        s.next()
        return ("num", int(val, 0))
    if kind == "string":
        s.next()
        return ("str", val[1:-1])
    if kind == "name":
        s.next()
        return ("name", val)
    raise SyntaxError(f"unexpected token {val!r}")


# ------------------------------------------------------------- precompiles
_Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def _valid_g1(x, y):
    if x == 0 and y == 0:
        return True
    return x < _Q and y < _Q and (y * y - x * x * x - 3) % _Q == 0


def _precompile(addr, words_in, n_in_bytes, n_out_words):
    """EVM precompile model over 32-byte words. Returns (ok, out_words)."""
    from ..curves import ref

    if addr == 2:  # sha256 (not used via staticcall by current exporters)
        data = b"".join(int(w).to_bytes(32, "big") for w in words_in)
        h = hashlib.sha256(data[:n_in_bytes]).digest()
        return True, [int.from_bytes(h, "big")]
    if addr == 5:  # modexp: [bsize, esize, msize, base, exp, mod]
        bs, es, ms, base, exp, mod = words_in[:6]
        assert bs == es == ms == 32, "exporter always uses 32-byte operands"
        if mod == 0:
            return True, [0]
        return True, [pow(base, exp, mod)]
    if addr == 6:  # ecAdd
        ax, ay, bx, by = (int(w) for w in words_in[:4])
        if not (_valid_g1(ax, ay) and _valid_g1(bx, by)):
            return False, [0] * n_out_words
        p1 = None if ax == ay == 0 else (ax, ay)
        p2 = None if bx == by == 0 else (bx, by)
        r = ref.G1.add(p1, p2)
        return True, [0, 0] if r is None else [r[0], r[1]]
    if addr == 7:  # ecMul
        x, y, k = (int(w) for w in words_in[:3])
        if not _valid_g1(x, y):
            return False, [0, 0]
        pt = None if x == y == 0 else (x, y)
        r = ref.G1.mul(pt, k) if pt is not None else None
        return True, [0, 0] if r is None else [r[0], r[1]]
    if addr == 8:  # ecPairing: 6-word groups (x, y, X_im, X_re, Y_im, Y_re)
        n_words = n_in_bytes // 32
        assert n_words % 6 == 0
        pairs = []
        for i in range(0, n_words, 6):
            x, y, xi, xr, yi, yr = (int(w) for w in words_in[i : i + 6])
            if not _valid_g1(x, y):
                return False, [0]
            qx, qy = ref.Fp2(xr, xi), ref.Fp2(yr, yi)
            if not (qx.is_zero() and qy.is_zero()):
                q = (qx, qy)
                if not ref.G2.on_curve(q) or not ref.G2.in_subgroup(q):
                    return False, [0]
            else:
                q = None
            p = None if x == y == 0 else (x, y)
            if p is not None and q is not None:
                pairs.append((p, q))
        ok = ref.pairing_check(pairs) if pairs else True
        return True, [1 if ok else 0]
    raise NotImplementedError(f"precompile {addr}")


# ------------------------------------------------------------ interpreter
class _Return(Exception):
    def __init__(self, value):
        self.value = value


class Contract:
    """Parsed + executable verifier contract."""

    def __init__(self, src: str):
        self.consts, self.funcs = parse_contract(src)

    def call(self, fname: str, *args):
        """Invoke a contract function; raises ContractRevert on revert."""
        return self._call(fname, list(args))

    # -- internals
    def _call(self, fname, args):
        fn = self.funcs[fname]
        env = dict(zip(fn["params"], args))
        for r in fn["rets"]:
            if r is not None:
                env.setdefault(r, 0)
        try:
            self._exec(fn["body"], env)
        except _Return as r:
            return r.value
        named = [r for r in fn["rets"] if r is not None]
        if named:
            vals = [env[r] for r in named]
            return vals[0] if len(vals) == 1 else tuple(vals)
        return None

    def _exec(self, node, env):
        kind = node[0]
        if kind == "block":
            for st in node[1]:
                self._exec(st, env)
        elif kind == "decl":
            name, e = node[1], node[2]
            env[name] = self._eval(e, env) if e is not None else 0
        elif kind == "assign":
            lv, e = node[1], node[2]
            val = self._eval(e, env)
            self._store(lv, val, env)
        elif kind == "tupleassign":
            vals = self._eval(node[2], env)
            for n, v in zip(node[1], vals):
                env[n] = v
        elif kind == "if":
            if self._truthy(self._eval(node[1], env)):
                self._exec(node[2], env)
            elif node[3] is not None:
                self._exec(node[3], env)
        elif kind == "for":
            self._exec(node[1], env)
            while self._truthy(self._eval(node[2], env)):
                self._exec(node[4], env)
                self._exec(node[3], env)
        elif kind == "return":
            raise _Return(self._eval(node[1], env) if node[1] is not None else None)
        elif kind == "revert":
            raise ContractRevert(node[1])
        elif kind == "staticcall":
            # args: gas(), addr, in_ptr, in_bytes, out_ptr, out_bytes
            _, target, args = node
            addr = self._eval(args[1], env)
            mem_in = self._eval(args[2], env)
            n_in = self._eval(args[3], env)
            mem_out = self._eval(args[4], env)
            n_out = self._eval(args[5], env) // 32
            ok, out = _precompile(addr, mem_in, n_in, n_out)
            if ok:
                if isinstance(mem_out, list):
                    for i in range(min(n_out, len(out))):
                        mem_out[i] = out[i]
            env[target] = ok
        elif kind == "expr":
            self._eval(node[1], env)
        else:
            raise NotImplementedError(kind)

    def _store(self, lv, val, env):
        if lv[0] == "name":
            env[lv[1]] = val
        elif lv[0] == "index":
            arr = self._eval(lv[1], env)
            arr[self._eval(lv[2], env)] = val
        else:
            raise NotImplementedError(lv[0])

    @staticmethod
    def _truthy(v):
        return bool(v) if isinstance(v, bool) else v != 0

    def _encode_packed(self, vals):
        out = b""
        for v in vals:
            if isinstance(v, str):
                out += v.encode()
            elif isinstance(v, bytes):
                out += v
            elif isinstance(v, list):
                out += b"".join(int(x).to_bytes(32, "big") for x in v)
            else:
                out += int(v).to_bytes(32, "big")
        return out

    def _eval(self, e, env):
        kind = e[0]
        if kind == "num":
            return e[1]
        if kind == "str":
            return e[1]
        if kind == "name":
            n = e[1]
            if n in env:
                return env[n]
            if n in self.consts:
                return self.consts[n]
            raise NameError(n)
        if kind == "array":
            return [self._eval(x, env) for x in e[1]]
        if kind == "tuple":
            return tuple(self._eval(x, env) for x in e[1])
        if kind == "index":
            return self._eval(e[1], env)[self._eval(e[2], env)]
        if kind == "ternary":
            return (
                self._eval(e[2], env)
                if self._truthy(self._eval(e[1], env))
                else self._eval(e[3], env)
            )
        if kind == "not":
            return not self._truthy(self._eval(e[1], env))
        if kind == "neg":
            return -self._eval(e[1], env)
        if kind == "bin":
            op = e[1]
            if op == "||":
                return self._truthy(self._eval(e[2], env)) or self._truthy(
                    self._eval(e[3], env)
                )
            if op == "&&":
                return self._truthy(self._eval(e[2], env)) and self._truthy(
                    self._eval(e[3], env)
                )
            a = self._eval(e[2], env)
            b = self._eval(e[3], env)
            if op == "==":
                return a == b
            if op == "!=":
                return a != b
            if op == "<":
                return a < b
            if op == ">":
                return a > b
            if op == "<=":
                return a <= b
            if op == ">=":
                return a >= b
            if op == "+":
                return (a + b) % (1 << 256)
            if op == "-":
                return (a - b) % (1 << 256)
            if op == "*":
                return (a * b) % (1 << 256)
            if op == "/":
                return a // b
            if op == "%":
                return a % b
            raise NotImplementedError(op)
        if kind == "methodcall":
            # abi.encodePacked(...)
            base, attr, args = e[1], e[2], e[3]
            if base == ("name", "abi") and attr == "encodePacked":
                return self._encode_packed([self._eval(a, env) for a in args])
            raise NotImplementedError(f"{base}.{attr}")
        if kind == "call":
            fname, args = e[1], e[2]
            vals = [self._eval(a, env) for a in args]
            if fname == "sha256":
                return hashlib.sha256(vals[0]).digest()
            if fname == "uint256":
                v = vals[0]
                return int.from_bytes(v, "big") if isinstance(v, bytes) else int(v)
            if fname == "bytes32":
                v = vals[0]
                return v if isinstance(v, bytes) else int(v).to_bytes(32, "big")
            if fname == "mulmod":
                return vals[0] * vals[1] % vals[2]
            if fname == "addmod":
                return (vals[0] + vals[1]) % vals[2]
            if fname == "gas":
                return 10**9
            if fname in self.funcs:
                return self._call(fname, vals)
            raise NotImplementedError(fname)
        raise NotImplementedError(kind)
