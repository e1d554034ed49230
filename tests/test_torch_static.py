"""The port's static graph (``paddle_tpu_torch.static``): programs of
deferred ops, ``Executor`` evaluation on its place (the CPU here, asked
for), ``optimizer.minimize`` update ops, gradients, persistence and the
graph utilities, held case for case to the reference's
``tests/test_static.py``; the closing cases run the same program in both
packages from the same initial weights and hold the port's fetches to
the reference's."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.static as rstatic
import paddle_tpu_torch as ptt
import paddle_tpu_torch.static as static
from paddle_tpu_torch.core.errors import InvalidArgumentError

CPU = "cpu"


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def _linreg(ns, st):
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("x", [-1, 4], "float32")
        y = st.data("y", [-1, 1], "float32")
        pred = st.nn.fc(x, 1)
        loss = ns.mean(ns.square(pred - y))
    return main, startup, x, y, pred, loss


@pytest.fixture
def linreg(rng):
    """A fresh linear-regression program and its data."""
    xs = rng.randn(32, 4).astype(np.float32)
    ys = xs @ np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    return _linreg(ptt, static) + (xs, ys)


def test_build_and_eval(linreg):
    main, startup, x, y, pred, loss, xs, ys = linreg
    assert isinstance(pred, static.Variable)
    assert pred.shape == (-1, 1)  # the batch stays open
    exe = static.Executor(CPU)
    exe.run(startup)
    (out,) = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[pred])
    assert out.shape == (32, 1)
    (out2,) = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[pred.name])
    np.testing.assert_array_equal(out, out2)


def test_uninitialized_raises(linreg):
    main, startup, x, y, pred, loss, xs, ys = linreg
    with static.scope_guard(static.Scope()):
        with pytest.raises(InvalidArgumentError):
            static.Executor(CPU).run(main, feed={"x": xs, "y": ys},
                                     fetch_list=[pred])


@pytest.mark.parametrize("compiled", [False, True])
def test_sgd_minimize_trains(linreg, compiled):
    main, startup, x, y, pred, loss, xs, ys = linreg
    with static.program_guard(main, startup):
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = static.Executor(CPU)
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        prog = static.CompiledProgram(main) if compiled else main
        losses = [float(exe.run(prog, feed={"x": xs, "y": ys},
                                fetch_list=[loss])[0]) for _ in range(60)]
        assert losses[-1] < losses[0] * 0.1, losses[::20]


def test_adam_state_slots_in_scope(linreg):
    main, startup, x, y, pred, loss, xs, ys = linreg
    with static.program_guard(main, startup):
        ptt.optimizer.Adam(learning_rate=0.05).minimize(loss)
    exe = static.Executor(CPU)
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        scope = static.global_scope()
        moment_keys = [k for k in scope._values if "__moment" in k]
        assert moment_keys, list(scope._values)
        before = scope._values[moment_keys[0]].clone()
        exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        assert not torch.equal(before, scope._values[moment_keys[0]])


def test_gradients_vs_numeric(linreg):
    main, startup, x, y, pred, loss, xs, ys = linreg
    w = main.all_parameters()[0]
    with static.program_guard(main, startup):
        (g,) = static.gradients([loss], [w])
    exe = static.Executor(CPU)
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        feed = {"x": xs, "y": ys}
        (gv,) = exe.run(main, feed=feed, fetch_list=[g])
        scope = static.global_scope()
        base = scope._values[w.name].clone()
        eps = 1e-3
        bumped = base.clone()
        bumped[0, 0] += eps
        scope._values[w.name] = bumped
        (l1,) = exe.run(main, feed=feed, fetch_list=[loss])
        scope._values[w.name] = base - torch.from_numpy(
            np.eye(4, 1, dtype=np.float32)) * eps
        (l0,) = exe.run(main, feed=feed, fetch_list=[loss])
        numeric = (float(l1) - float(l0)) / (2 * eps)
        np.testing.assert_allclose(gv[0, 0], numeric, rtol=1e-2)


def test_append_backward(linreg):
    main, startup, x, y, pred, loss, xs, ys = linreg
    with static.program_guard(main, startup):
        pairs = static.append_backward(loss)
    assert len(pairs) == len(main.all_parameters())
    for p, g in pairs:
        assert g.shape == p.shape


def test_save_load_roundtrip(tmp_path, linreg):
    main, startup, x, y, pred, loss, xs, ys = linreg
    exe = static.Executor(CPU)
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        feed = {"x": xs, "y": ys}
        before = exe.run(main, feed=feed, fetch_list=[pred])[0]
        static.save(main, str(tmp_path / "model"))
        scope = static.global_scope()
        w = main.all_parameters()[0]
        scope._values[w.name] = torch.zeros_like(scope._values[w.name])
        static.load(main, str(tmp_path / "model"))
        after = exe.run(main, feed=feed, fetch_list=[pred])[0]
        np.testing.assert_allclose(before, after, rtol=1e-5)
        state = static.load_program_state(str(tmp_path / "model"))
        assert w.name in state
        static.set_program_state(main, state)


def test_inference_model_roundtrip(tmp_path, linreg):
    main, startup, x, y, pred, loss, xs, ys = linreg
    exe = static.Executor(CPU)
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        path = str(tmp_path / "inf" / "model")
        static.save_inference_model(path, [x], [pred], exe, program=main)
        prog, feed_names, fetches = static.load_inference_model(path, exe)
        assert feed_names == ["x"]
        out = exe.run(prog, feed={"x": xs[:5]}, fetch_list=fetches)[0]
        assert out.shape == (5, 1)
        blob = static.serialize_program([x], [pred])
        doc = static.deserialize_program(blob)
        assert doc["feeds"][0]["name"] == "x"
        pblob = static.serialize_persistables([x], [pred])
        static.deserialize_persistables(main, pblob)


def test_py_func_print_metrics(linreg, capsys):
    main, startup, x, y, pred, loss, xs, ys = linreg
    with static.program_guard(main, startup):
        doubled = static.py_func(lambda a: a * 2, x, out=x)
        printed = static.Print(loss, message="static-loss:")
        probs = static.data("probs", [-1, 2], "float32")
        lab = static.data("lab", [-1, 1], "int64")
        acc = static.accuracy(probs, lab)
        auc_node, _, _ = static.auc(probs, lab)
    exe = static.Executor(CPU)
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        dv, _, accv, aucv = exe.run(main, feed={
            "x": xs, "y": ys,
            "probs": np.array([[0.1, 0.9], [0.8, 0.2]], np.float32),
            "lab": np.array([[1], [0]], np.int64)},
            fetch_list=[doubled, printed, acc, auc_node])
    np.testing.assert_allclose(dv, xs * 2)
    assert float(accv) == 1.0 and float(aucv) == 1.0
    assert "static-loss:" in capsys.readouterr().out


def test_static_auc_tied_scores_match_the_reference():
    """Tied (quantized) scores need midranks: the reference's node is the
    oracle here (sklearn's, in the reference's test)."""
    scores = np.array([0.5, 0.5, 0.5, 0.2, 0.8, 0.2, 0.8, 0.5], np.float32)
    labels = np.array([1, 0, 1, 0, 1, 1, 0, 0], np.int64)

    def run(st, exe):
        main, startup = st.Program(), st.Program()
        with st.program_guard(main, startup):
            probs = st.data("probs", [-1], "float32")
            lab = st.data("lab", [-1], "int64")
            auc_node, _, _ = st.auc(probs, lab)
        with st.scope_guard(st.Scope()):
            exe.run(startup)
            return float(exe.run(main, feed={"probs": scores, "lab": labels},
                                 fetch_list=[auc_node])[0])

    got = run(static, static.Executor(CPU))
    want = run(rstatic, rstatic.Executor())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert 0.0 < got < 1.0


def test_variable_operators(linreg):
    main, startup, x, y, pred, loss, xs, ys = linreg
    with static.program_guard(main, startup):
        z = (x * 2 + 1).mean()
    (zv,) = static.Executor(CPU).run(main, feed={"x": xs, "y": ys},
                                     fetch_list=[z])
    np.testing.assert_allclose(zv, (xs * 2 + 1).mean(), rtol=1e-6)


def test_fetch_by_name_requires_known_var(linreg):
    main, startup, x, y, pred, loss, xs, ys = linreg
    with pytest.raises(InvalidArgumentError):
        static.Executor(CPU).run(main, feed={"x": xs}, fetch_list=["nope"])


def test_multi_output_ops(linreg):
    main, startup, x, y, pred, loss, xs, ys = linreg
    with static.program_guard(main, startup):
        values, indices = ptt.topk(x, k=2)
        parts = ptt.split(x, 2, axis=1)
    v, i, p0, p1 = static.Executor(CPU).run(
        main, feed={"x": xs, "y": ys},
        fetch_list=[values, indices, parts[0], parts[1]])
    wv, wi = np.sort(xs, 1)[:, ::-1][:, :2], np.argsort(-xs, 1)[:, :2]
    np.testing.assert_allclose(v, wv, rtol=1e-6)
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_allclose(p0, xs[:, :2], rtol=1e-6)
    np.testing.assert_allclose(p1, xs[:, 2:], rtol=1e-6)


def test_print_pyfunc_under_compiled_program(linreg, capsys):
    main, startup, x, y, pred, loss, xs, ys = linreg
    with static.program_guard(main, startup):
        printed = static.Print(loss, message="jit-loss:")
        doubled = static.py_func(lambda a: a * 2, x, out=x)
        two = static.py_func(lambda a: (a + 1, a - 1), x, out=[x, x])
    exe = static.Executor(CPU)
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        pv, dv, t0, t1 = exe.run(static.CompiledProgram(main),
                                 feed={"x": xs, "y": ys},
                                 fetch_list=[printed, doubled, two[0],
                                             two[1]])
    np.testing.assert_allclose(dv, xs * 2, rtol=1e-6)
    np.testing.assert_allclose(t0, xs + 1, rtol=1e-6)
    np.testing.assert_allclose(t1, xs - 1, rtol=1e-6)
    assert "jit-loss:" in capsys.readouterr().out


def test_joint_gradients_single_backward(linreg):
    main, startup, x, y, pred, loss, xs, ys = linreg
    params = main.all_parameters()
    with static.program_guard(main, startup):
        gs = static.gradients([loss], params)
    assert len(gs) == len(params)
    assert len({id(g.inputs[0][0]) for g in gs if g.inputs[0]}) <= 1
    exe = static.Executor(CPU)
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        outs = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=gs)
    for g, p in zip(outs, params):
        assert g.shape == tuple(p.shape) and np.isfinite(g).all()


def test_static_nn_layers(rng):
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        img = static.data("img", [-1, 3, 8, 8], "float32")
        conv = static.nn.conv2d(img, num_filters=4, filter_size=3,
                                padding=1, act="relu")
        bn = static.nn.batch_norm(conv)
        ids = static.data("ids", [-1, 5], "int64")
        emb = static.nn.embedding(ids, size=[32, 6])
        feat = ptt.concat([bn.mean(axis=[2, 3]), emb.mean(axis=1)], axis=1)
        logits = static.nn.fc(feat, 2)
        lab = static.data("lab", [-1], "int64")
        loss = ptt.mean(ptt.nn.functional.cross_entropy(logits, lab))
        ptt.optimizer.Adam(learning_rate=0.01).minimize(loss)
    exe = static.Executor(CPU)
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        feed = {"img": rng.randn(16, 3, 8, 8).astype(np.float32),
                "ids": rng.randint(0, 32, (16, 5)).astype(np.int64),
                "lab": rng.randint(0, 2, (16,)).astype(np.int64)}
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                  for _ in range(15)]
        assert losses[-1] < losses[0], losses[::7]
        scope = static.global_scope()
        means = [k for k in scope._values
                 if k.endswith("_mean") and k.startswith("bn_")]
        variances = [k for k in scope._values
                     if k.endswith("_variance") and k.startswith("bn_")]
        assert means and variances
        assert any(not np.allclose(scope._values[k].numpy(), 0.0)
                   for k in means)
        assert any(not np.allclose(scope._values[k].numpy(), 1.0)
                   for k in variances)


def test_executor_runs_on_the_card_unless_asked():
    if not torch.cuda.is_available():
        with pytest.raises(ptt.UnavailableError):
            static.Executor()
    assert static.Executor(static.cpu_places()[0]).place.type == "cpu"
    assert static.cuda_places([0])[0] == torch.device("cuda", 0)


# -- the same programs in both packages ------------------------------------


@pytest.mark.parametrize("opt", ["SGD", "Momentum", "Adam"])
def test_trained_program_matches_the_reference(opt, rng):
    """The regression program trained 3 steps by ``Executor`` + ``minimize``
    in both packages, from the reference's initial weights: each step's
    loss and the final weights agree."""
    xs = rng.randn(32, 4).astype(np.float32)
    ys = xs @ np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    kwargs = {"learning_rate": 0.05}
    if opt == "Momentum":
        kwargs["momentum"] = 0.9
    out = {}
    for ns, st, exe in ((pt, rstatic, rstatic.Executor()),
                        (ptt, static, static.Executor(CPU))):
        main, startup, x, y, pred, loss = _linreg(ns, st)
        with st.program_guard(main, startup):
            getattr(ns.optimizer, opt)(**kwargs).minimize(loss)
        with st.scope_guard(st.Scope()):
            exe.run(startup)
            names = [p.name for p in main.all_parameters()]
            if ns is ptt:  # start from the reference's initial weights
                for n, w in zip(names, out["init"]):
                    st.global_scope()._values[n] = torch.from_numpy(w)
            else:
                out["init"] = [np.asarray(st.global_scope()._values[n])
                               for n in names]
            losses = [float(exe.run(main, feed={"x": xs, "y": ys},
                                    fetch_list=[loss])[0])
                      for _ in range(3)]
            weights = [np.asarray(st.global_scope().find_var(n)
                                  .get_tensor()) for n in names]
        out[ns.__name__] = (losses, weights)
    (rl, rw), (pl, pw) = out["paddle_tpu"], out["paddle_tpu_torch"]
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    for a, b in zip(pw, rw):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
