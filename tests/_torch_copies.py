"""Copy fidelity of the port's modules that are copies of the reference's:
each module cut into units whose ASTs are compared after the package name
is rewritten."""
import ast
import copy
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def statement(src):
    """The unit key of one top-level statement other than a function or a
    class (an import, an assignment), as ``units`` names it."""
    return f"statement {ast.dump(ast.parse(src).body[0])}"


def units(src):
    """{unit: AST dump} of a module: the docstring, each top-level function,
    each class without its methods, each method; any other statement is
    keyed by its own dump."""
    tree = ast.parse(src)
    body, out = tree.body, {}
    if ast.get_docstring(tree) is not None:
        out["__doc__"], body = ast.dump(body[0]), body[1:]
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in body:
        if isinstance(node, funcs):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            methods = [n for n in node.body if isinstance(n, funcs)]
            out.update((f"{node.name}.{m.name}", ast.dump(m))
                       for m in methods)
            rest = copy.copy(node)
            rest.body = [n for n in node.body if not isinstance(n, funcs)]
            out[node.name] = ast.dump(rest)
        else:
            out[f"statement {ast.dump(node)}"] = ""
    return out


def differing_units(path):
    """The units of ``paddle_tpu_torch/<path>`` that differ from
    ``paddle_tpu/<path>``'s; a class on one side only counts once, not
    method by method."""
    ref = units((REPO / "paddle_tpu" / path).read_text())
    port = units((REPO / "paddle_tpu_torch" / path).read_text()
                 .replace("paddle_tpu_torch", "paddle_tpu"))
    both = ref.keys() & port.keys()
    return {k if k.startswith("statement ") or k.split(".")[0] in both
            else k.split(".")[0]
            for k in ref.keys() | port.keys() if ref.get(k) != port.get(k)}
