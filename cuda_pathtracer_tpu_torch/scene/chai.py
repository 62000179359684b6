"""Chai-script scene loader — a real interpreter for the chaiscript surface.
The port's copy of ``cuda_pathtracer_tpu/scene/chai.py``.

The reference embeds the full chaiscript VM and registers a small
scene-building API (getScriptedScene, src/sceneBuilder.h:271-306):
Material/GameObject/Plane/float3 types, DiffuseMaterial, make_float3 and the
scene_add_* functions. Scripts there are a complete language — loops,
conditionals, arithmetic on variables, user functions.

This module implements that language surface natively: a tokenizer, a
recursive-descent parser and a tree-walking evaluator (no Python ``exec`` or
``eval`` anywhere — the script can only touch the registered API). Supported
chaiscript constructs:

  * ``var`` declarations, assignment and compound assignment (= += -= *= /=)
    to names and to member chains (``obj.rotation.y = pi/2``)
  * expressions: numeric literals (with chai's ``1.0f`` suffix), strings,
    ``true/false``, arithmetic (+ - * / %), comparisons, ``&& || !``,
    unary minus, prefix/postfix ``++``/``--``, parentheses, function calls
  * control flow: ``if / else if / else``, ``while``, C-style ``for``,
    ``break``, ``continue``
  * user functions: ``def name(a, b) { ... return expr; }`` with proper
    lexical block scoping and recursion
  * ``//`` and ``/* */`` comments; statements end at ``;`` or end-of-line
    (newlines inside parentheses continue the statement, as in
    example_scene.chai:10-14)

Statement/loop execution is budgeted (default 10M steps) so a runaway script
fails fast instead of hanging the host.
"""
from __future__ import annotations

import numpy as np

from .scene import Scene, Material, GameObject, Plane as ScenePlane


class float3:
    """Mutable xyz value with the chai-registered field accessors."""

    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x = float(x)
        self.y = float(y)
        self.z = float(z)

    def tuple(self):
        return (self.x, self.y, self.z)

    def __repr__(self):
        return f'float3({self.x}, {self.y}, {self.z})'


def make_float3(a, b=None, c=None) -> float3:
    if b is None:
        return float3(a, a, a)
    return float3(a, b, c)


class ChaiMaterial:
    """Adapter exposing the chai-registered Material fields
    (sceneBuilder.h:287-294)."""

    _fields = ('diffuse_color', 'specular_color', 'emission', 'reflect',
               'glossy', 'transmit', 'refractive_index', 'absorption')

    def __init__(self, diffuse: float3):
        self.diffuse_color = diffuse
        self.specular_color = float3()
        self.emission = float3()
        self.reflect = 0.0
        self.glossy = 0.0
        self.transmit = 0.0
        self.refractive_index = 0.0
        self.absorption = float3()

    def to_material(self) -> Material:
        def t(v):
            return v.tuple() if isinstance(v, float3) else (v, v, v)
        return Material(diffuse_color=t(self.diffuse_color),
                        specular_color=t(self.specular_color),
                        emission=t(self.emission),
                        reflect=float(self.reflect),
                        glossy=float(self.glossy),
                        transmit=float(self.transmit),
                        refractive_index=float(self.refractive_index),
                        absorption=t(self.absorption))


def DiffuseMaterial(color: float3) -> ChaiMaterial:
    return ChaiMaterial(color)


class ChaiGameObject:
    _fields = ('position', 'rotation', 'scale', 'model_id')

    def __init__(self, model_id: int):
        self.model_id = int(model_id)
        self.position = float3()
        self.rotation = float3()
        self.scale = float3(1, 1, 1)

    def to_object(self) -> GameObject:
        return GameObject(self.model_id,
                          position=np.array(self.position.tuple()),
                          rotation=np.array(self.rotation.tuple()),
                          scale=np.array(self.scale.tuple()))


class ChaiPlane:
    _fields = ('normal', 'd', 'material')

    def __init__(self, normal: float3, d, material):
        self.normal = normal
        self.d = float(d)
        self.material = int(material)


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_PUNCT = ('&&', '||', '==', '!=', '<=', '>=', '++', '--',
          '+=', '-=', '*=', '/=',
          '(', ')', '{', '}', ',', ';', '.', '+', '-', '*', '/', '%',
          '<', '>', '=', '!')
_KEYWORDS = frozenset(('var', 'if', 'else', 'while', 'for', 'def', 'return',
                       'break', 'continue', 'true', 'false'))


class Tok:
    __slots__ = ('kind', 'val', 'line')

    def __init__(self, kind, val, line):
        self.kind = kind      # 'num' 'str' 'name' 'kw' 'punct' 'nl' 'eof'
        self.val = val
        self.line = line

    def __repr__(self):
        return f'{self.kind}:{self.val!r}'


def _tokenize(src: str, path: str):
    toks = []
    i, n, line = 0, len(src), 1
    depth = 0               # paren depth: newlines inside parens are ignored
    while i < n:
        c = src[i]
        if c == '\n':
            line += 1
            if depth == 0:
                toks.append(Tok('nl', '\n', line - 1))
            i += 1
            continue
        if c in ' \t\r':
            i += 1
            continue
        if src.startswith('//', i) or c == '#':
            while i < n and src[i] != '\n':
                i += 1
            continue
        if src.startswith('/*', i):
            j = src.find('*/', i + 2)
            if j < 0:
                raise ChaiError(path, line, 'unterminated /* comment')
            line += src.count('\n', i, j)
            i = j + 2
            continue
        if c == '"':
            j = i + 1
            buf = []
            while j < n and src[j] != '"':
                if src[j] == '\\' and j + 1 < n:
                    esc = src[j + 1]
                    buf.append({'n': '\n', 't': '\t', '"': '"',
                                '\\': '\\'}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise ChaiError(path, line, 'unterminated string')
            toks.append(Tok('str', ''.join(buf), line))
            i = j + 1
            continue
        if c.isdigit() or (c == '.' and i + 1 < n and src[i + 1].isdigit()):
            j = i
            while j < n and (src[j].isdigit() or src[j] == '.'):
                j += 1
            text = src[i:j]
            if j < n and src[j] in 'fF':      # chai float suffix: 5.0f
                j += 1
            toks.append(Tok('num', float(text) if '.' in text else int(text),
                            line))
            i = j
            continue
        if c.isalpha() or c == '_':
            j = i
            while j < n and (src[j].isalnum() or src[j] == '_'):
                j += 1
            word = src[i:j]
            toks.append(Tok('kw' if word in _KEYWORDS else 'name', word, line))
            i = j
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                if p == '(':
                    depth += 1
                elif p == ')':
                    depth = max(0, depth - 1)
                toks.append(Tok('punct', p, line))
                i += len(p)
                break
        else:
            raise ChaiError(path, line, f'unexpected character {c!r}')
    toks.append(Tok('eof', None, line))
    return toks


class ChaiError(RuntimeError):
    def __init__(self, path, line, msg):
        super().__init__(f'{path}:{line}: {msg}')
        self.line = line


# ---------------------------------------------------------------------------
# Parser — produces plain-tuple AST nodes: (op, line, *args)
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks, path):
        self.toks = toks
        self.i = 0
        self.path = path

    # -- token plumbing --
    def peek(self, skip_nl=False):
        i = self.i
        if skip_nl:
            while self.toks[i].kind == 'nl':
                i += 1
        return self.toks[i]

    def next(self, skip_nl=False):
        if skip_nl:
            while self.toks[self.i].kind == 'nl':
                self.i += 1
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val, skip_nl=True):
        t = self.next(skip_nl=skip_nl)
        if t.val != val:
            raise ChaiError(self.path, t.line,
                            f'expected {val!r}, got {t.val!r}')
        return t

    def at(self, val, skip_nl=False):
        t = self.peek(skip_nl=skip_nl)
        return (t.kind in ('punct', 'kw')) and t.val == val

    def _skip_terminators(self):
        while self.peek().kind == 'nl' or self.at(';'):
            self.next()

    def _end_statement(self):
        t = self.peek()
        if t.kind in ('nl', 'eof') or t.val in (';', '}'):
            self._skip_terminators()
            return
        raise ChaiError(self.path, t.line,
                        f'expected end of statement, got {t.val!r}')

    # -- grammar --
    def parse_program(self):
        body = []
        self._skip_terminators()
        while self.peek().kind != 'eof':
            body.append(self.statement())
            self._skip_terminators()
        return body

    def block(self):
        """{ stmts } or a single statement."""
        if self.at('{', skip_nl=True):
            self.next(skip_nl=True)
            body = []
            self._skip_terminators()
            while not self.at('}', skip_nl=True):
                body.append(self.statement())
                self._skip_terminators()
            self.expect('}')
            return body
        return [self.statement()]

    def statement(self):
        t = self.peek(skip_nl=True)
        line = t.line
        if t.kind == 'kw':
            if t.val == 'var':
                self.next(skip_nl=True)
                name = self.next(skip_nl=True)
                if name.kind != 'name':
                    raise ChaiError(self.path, name.line,
                                    f'bad var name {name.val!r}')
                init = None
                if self.at('='):
                    self.next()
                    init = self.expression()
                self._end_statement()
                return ('var', line, name.val, init)
            if t.val == 'if':
                return self.if_statement()
            if t.val == 'while':
                self.next(skip_nl=True)
                self.expect('(')
                cond = self.expression()
                self.expect(')')
                body = self.block()
                return ('while', line, cond, body)
            if t.val == 'for':
                self.next(skip_nl=True)
                self.expect('(')
                init = None if self.at(';', skip_nl=True) \
                    else self.simple_statement()
                self.expect(';')
                cond = None if self.at(';', skip_nl=True) \
                    else self.expression()
                self.expect(';')
                step = None if self.at(')', skip_nl=True) \
                    else self.simple_statement()
                self.expect(')')
                body = self.block()
                return ('for', line, init, cond, step, body)
            if t.val == 'def':
                self.next(skip_nl=True)
                name = self.next(skip_nl=True)
                if name.kind != 'name':
                    raise ChaiError(self.path, name.line,
                                    f'bad function name {name.val!r}')
                self.expect('(')
                params = []
                if not self.at(')', skip_nl=True):
                    while True:
                        p = self.next(skip_nl=True)
                        if p.kind != 'name':
                            raise ChaiError(self.path, p.line,
                                            f'bad parameter {p.val!r}')
                        params.append(p.val)
                        if self.at(',', skip_nl=True):
                            self.next(skip_nl=True)
                        else:
                            break
                self.expect(')')
                body = self.block()
                return ('def', line, name.val, params, body)
            if t.val == 'return':
                self.next(skip_nl=True)
                val = None
                nxt = self.peek()
                if not (nxt.kind in ('nl', 'eof') or nxt.val in (';', '}')):
                    val = self.expression()
                self._end_statement()
                return ('return', line, val)
            if t.val == 'break':
                self.next(skip_nl=True)
                self._end_statement()
                return ('break', line)
            if t.val == 'continue':
                self.next(skip_nl=True)
                self._end_statement()
                return ('continue', line)
        stmt = self.simple_statement()
        self._end_statement()
        return stmt

    def if_statement(self):
        t = self.next(skip_nl=True)       # 'if'
        self.expect('(')
        cond = self.expression()
        self.expect(')')
        then = self.block()
        other = []
        if self.at('else', skip_nl=True):
            self.next(skip_nl=True)
            if self.at('if', skip_nl=True):
                other = [self.if_statement()]
            else:
                other = self.block()
        return ('if', t.line, cond, then, other)

    def simple_statement(self):
        """var decl (for-init), assignment or expression — no terminator."""
        if self.at('var', skip_nl=True):
            self.next(skip_nl=True)
            name = self.next(skip_nl=True)
            init = None
            if self.at('='):
                self.next()
                init = self.expression()
            return ('var', name.line, name.val, init)
        expr = self.expression()
        t = self.peek()
        if t.kind == 'punct' and t.val in ('=', '+=', '-=', '*=', '/='):
            self.next()
            rhs = self.expression()
            if expr[0] not in ('name', 'attr'):
                raise ChaiError(self.path, t.line,
                                'left side of assignment must be a name or '
                                'a member chain')
            return ('assign', t.line, t.val, expr, rhs)
        return ('expr', expr[1], expr)

    # expressions, precedence-climbing
    def expression(self):
        return self.or_expr()

    def or_expr(self):
        left = self.and_expr()
        while self.at('||', skip_nl=True):
            line = self.next(skip_nl=True).line
            left = ('or', line, left, self.and_expr())
        return left

    def and_expr(self):
        left = self.cmp_expr()
        while self.at('&&', skip_nl=True):
            line = self.next(skip_nl=True).line
            left = ('and', line, left, self.cmp_expr())
        return left

    def cmp_expr(self):
        left = self.add_expr()
        while True:
            t = self.peek(skip_nl=True)
            if t.kind == 'punct' and t.val in ('==', '!=', '<', '<=',
                                               '>', '>='):
                self.next(skip_nl=True)
                left = ('binop', t.line, t.val, left, self.add_expr())
            else:
                return left

    def add_expr(self):
        left = self.mul_expr()
        while True:
            t = self.peek(skip_nl=True)
            if t.kind == 'punct' and t.val in ('+', '-'):
                self.next(skip_nl=True)
                left = ('binop', t.line, t.val, left, self.mul_expr())
            else:
                return left

    def mul_expr(self):
        left = self.unary_expr()
        while True:
            t = self.peek(skip_nl=True)
            if t.kind == 'punct' and t.val in ('*', '/', '%'):
                self.next(skip_nl=True)
                left = ('binop', t.line, t.val, left, self.unary_expr())
            else:
                return left

    def unary_expr(self):
        t = self.peek(skip_nl=True)
        if t.kind == 'punct' and t.val in ('-', '!', '++', '--'):
            self.next(skip_nl=True)
            if t.val in ('++', '--'):
                target = self.unary_expr()
                return ('incdec', t.line, t.val, target, True)
            return ('unary', t.line, t.val, self.unary_expr())
        return self.postfix_expr()

    def postfix_expr(self):
        node = self.primary()
        while True:
            t = self.peek()
            if t.kind == 'punct' and t.val == '.':
                self.next()
                name = self.next(skip_nl=True)
                if name.kind != 'name':
                    raise ChaiError(self.path, name.line,
                                    f'bad member name {name.val!r}')
                node = ('attr', name.line, node, name.val)
            elif t.kind == 'punct' and t.val == '(':
                self.next()
                args = []
                if not self.at(')', skip_nl=True):
                    while True:
                        args.append(self.expression())
                        if self.at(',', skip_nl=True):
                            self.next(skip_nl=True)
                        else:
                            break
                self.expect(')')
                node = ('call', t.line, node, args)
            elif t.kind == 'punct' and t.val in ('++', '--'):
                self.next()
                node = ('incdec', t.line, t.val, node, False)
            else:
                return node

    def primary(self):
        t = self.next(skip_nl=True)
        if t.kind == 'num':
            return ('const', t.line, t.val)
        if t.kind == 'str':
            return ('const', t.line, t.val)
        if t.kind == 'kw' and t.val in ('true', 'false'):
            return ('const', t.line, t.val == 'true')
        if t.kind == 'name':
            return ('name', t.line, t.val)
        if t.kind == 'punct' and t.val == '(':
            e = self.expression()
            self.expect(')')
            return e
        raise ChaiError(self.path, t.line, f'unexpected token {t.val!r}')


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Function:
    def __init__(self, name, params, body, interp):
        self.name = name
        self.params = params
        self.body = body
        self.interp = interp

    def __call__(self, *args):
        if len(args) != len(self.params):
            raise TypeError(f'{self.name}() expects {len(self.params)} '
                            f'arguments, got {len(args)}')
        scope = dict(zip(self.params, args))
        try:
            self.interp.exec_block(self.body, [self.interp.globals, scope])
        except _Return as r:
            return r.value
        return None


# objects whose attributes scripts may read/write (the registered field
# accessors, sceneBuilder.h:287-299); everything else is opaque
_FIELD_TYPES = (float3, ChaiMaterial, ChaiGameObject, ChaiPlane)


class Interpreter:
    MAX_STEPS = 10_000_000

    def __init__(self, builtins: dict, path: str):
        self.globals = dict(builtins)
        self.path = path
        self.steps = 0

    def _tick(self, line):
        self.steps += 1
        if self.steps > self.MAX_STEPS:
            raise ChaiError(self.path, line,
                            f'script exceeded {self.MAX_STEPS} steps')

    def run(self, program):
        self.exec_block(program, [self.globals])

    # -- scoping --
    def _lookup(self, scopes, name, line):
        for s in reversed(scopes):
            if name in s:
                return s[name]
        raise ChaiError(self.path, line, f'undefined name {name!r}')

    def _set(self, scopes, name, value, line):
        for s in reversed(scopes):
            if name in s:
                s[name] = value
                return
        raise ChaiError(self.path, line,
                        f'assignment to undeclared name {name!r} '
                        f'(use var)')

    # -- statements --
    def exec_block(self, body, scopes):
        scopes = scopes + [{}]
        for stmt in body:
            self.exec_stmt(stmt, scopes)

    def exec_stmt(self, stmt, scopes):
        op, line = stmt[0], stmt[1]
        self._tick(line)
        if op == 'var':
            _, _, name, init = stmt
            scopes[-1][name] = (self.eval(init, scopes)
                               if init is not None else None)
        elif op == 'assign':
            _, _, aop, target, rhs = stmt
            val = self.eval(rhs, scopes)
            if aop != '=':
                cur = self.eval(target, scopes)
                val = self._binop(aop[0], cur, val, line)
            self._store(target, val, scopes)
        elif op == 'expr':
            self.eval(stmt[2], scopes)
        elif op == 'if':
            _, _, cond, then, other = stmt
            branch = then if self._truthy(cond, scopes) else other
            self.exec_block(branch, scopes)
        elif op == 'while':
            _, _, cond, body = stmt
            while self._truthy(cond, scopes):
                self._tick(line)
                try:
                    self.exec_block(body, scopes)
                except _Break:
                    break
                except _Continue:
                    continue
        elif op == 'for':
            _, _, init, cond, step, body = stmt
            scopes = scopes + [{}]     # for-init owns its own scope
            if init is not None:
                self.exec_stmt(init, scopes)
            while cond is None or self._truthy(cond, scopes):
                self._tick(line)
                try:
                    self.exec_block(body, scopes)
                except _Break:
                    break
                except _Continue:
                    pass
                if step is not None:
                    self.exec_stmt(step, scopes)
        elif op == 'def':
            _, _, name, params, body = stmt
            self.globals[name] = _Function(name, params, body, self)
        elif op == 'return':
            raise _Return(self.eval(stmt[2], scopes)
                          if stmt[2] is not None else None)
        elif op == 'break':
            raise _Break()
        elif op == 'continue':
            raise _Continue()
        else:                                    # pragma: no cover
            raise ChaiError(self.path, line, f'bad statement {op}')

    def _truthy(self, cond, scopes):
        return bool(self.eval(cond, scopes))

    def _store(self, target, value, scopes):
        if target[0] == 'name':
            self._set(scopes, target[2], value, target[1])
            return
        # attr chain: evaluate the base object, set the final field
        _, line, base, name = target
        obj = self.eval(base, scopes)
        if not isinstance(obj, _FIELD_TYPES) or name.startswith('_') \
                or not hasattr(obj, name):
            raise ChaiError(self.path, line,
                            f'cannot assign field {name!r} on '
                            f'{type(obj).__name__}')
        setattr(obj, name, value)

    # -- expressions --
    def eval(self, node, scopes):
        op, line = node[0], node[1]
        self._tick(line)
        if op == 'const':
            return node[2]
        if op == 'name':
            return self._lookup(scopes, node[2], line)
        if op == 'attr':
            obj = self.eval(node[2], scopes)
            name = node[3]
            if not isinstance(obj, _FIELD_TYPES) or name.startswith('_') \
                    or not hasattr(obj, name):
                raise ChaiError(self.path, line,
                                f'no field {name!r} on '
                                f'{type(obj).__name__}')
            return getattr(obj, name)
        if op == 'call':
            fn = self.eval(node[2], scopes)
            if not callable(fn):
                raise ChaiError(self.path, line, 'calling a non-function')
            args = [self.eval(a, scopes) for a in node[3]]
            try:
                return fn(*args)
            except ChaiError:
                raise
            except Exception as e:
                raise ChaiError(self.path, line,
                                f'{type(e).__name__}: {e}') from e
        if op == 'binop':
            a = self.eval(node[3], scopes)
            b = self.eval(node[4], scopes)
            return self._binop(node[2], a, b, line)
        if op == 'and':
            return (bool(self.eval(node[2], scopes))
                    and bool(self.eval(node[3], scopes)))
        if op == 'or':
            return (bool(self.eval(node[2], scopes))
                    or bool(self.eval(node[3], scopes)))
        if op == 'unary':
            v = self.eval(node[3], scopes)
            if node[2] == '-':
                return -v
            return not bool(v)
        if op == 'incdec':
            _, _, which, target, prefix = node
            if target[0] not in ('name', 'attr'):
                raise ChaiError(self.path, line, '++/-- needs a variable')
            cur = self.eval(target, scopes)
            new = cur + (1 if which == '++' else -1)
            self._store(target, new, scopes)
            return new if prefix else cur
        raise ChaiError(self.path, line,               # pragma: no cover
                        f'bad expression {op}')

    def _binop(self, op, a, b, line):
        try:
            if op == '+':
                return a + b
            if op == '-':
                return a - b
            if op == '*':
                return a * b
            if op == '/':
                # chai follows C: int/int is integer division
                if isinstance(a, int) and isinstance(b, int):
                    q = a // b
                    # C truncates toward zero
                    if q < 0 and q * b != a:
                        q += 1
                    return q
                return a / b
            if op == '%':
                if isinstance(a, int) and isinstance(b, int):
                    return int(np.fmod(a, b))
                return float(np.fmod(a, b))
            if op == '==':
                return a == b
            if op == '!=':
                return a != b
            if op == '<':
                return a < b
            if op == '<=':
                return a <= b
            if op == '>':
                return a > b
            if op == '>=':
                return a >= b
        except TypeError as e:
            raise ChaiError(self.path, line, str(e)) from e
        raise ChaiError(self.path, line, f'bad operator {op!r}')


# ---------------------------------------------------------------------------
# Scene entry point
# ---------------------------------------------------------------------------

def get_scripted_scene(path: str, asset_dirs=()) -> Scene:
    """Evaluate a .chai scene script (getScriptedScene,
    src/sceneBuilder.h:271-306)."""
    scene = Scene(asset_dirs=asset_dirs)

    def scene_add_material(mat: ChaiMaterial) -> int:
        return scene.add_material(mat.to_material())

    def scene_add_model(filename, scale, rotation: float3, offset: float3,
                        material, use_mtl=False) -> int:
        try:
            return scene.add_model(filename, float(scale), rotation.tuple(),
                                   offset.tuple(), int(material),
                                   bool(use_mtl))
        except FileNotFoundError:
            # scripts reference assets the reference repo doesn't ship
            # (sponza.obj in sponza.chai) — degrade to a procedural stand-in
            # of similar scale so the script still runs (see scene/procedural)
            import sys
            print(f'chai: {filename} not found; using a procedural stand-in',
                  file=sys.stderr)
            from . import procedural
            return procedural.add_cathedral(scene, int(material))

    def scene_add_plane(plane: ChaiPlane):
        scene.add_plane(ScenePlane(plane.normal.tuple(), plane.d,
                                   plane.material))

    def scene_add_object(obj: ChaiGameObject) -> int:
        return scene.add_object(obj.to_object())

    def chai_print(*args):
        import sys
        print(*args, file=sys.stderr)

    builtins = {
        'make_float3': make_float3,
        'float3': float3,
        'DiffuseMaterial': DiffuseMaterial,
        'GameObject': ChaiGameObject,
        'Plane': ChaiPlane,
        'scene_add_material': scene_add_material,
        'scene_add_model': scene_add_model,
        'scene_add_plane': scene_add_plane,
        'scene_add_object': scene_add_object,
        # alias tolerating the `cene_add_object` typo shipped in the
        # reference's example_scene.chai:17
        'cene_add_object': scene_add_object,
        # chaiscript stdlib surface scripts commonly touch
        'print': chai_print,
        'to_string': str,
        'min': min,
        'max': max,
    }

    with open(path) as f:
        src = f.read()
    toks = _tokenize(src, path)
    program = _Parser(toks, path).parse_program()
    Interpreter(builtins, path).run(program)

    scene.finalize()
    return scene
