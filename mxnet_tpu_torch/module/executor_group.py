"""DataParallelExecutorGroup (parity: mxnet_tpu/module/executor_group.py;
python/mxnet/module/executor_group.py — slices the batch across the ctx
list and owns one executor per device; forward:436, backward:572)."""
from __future__ import annotations

from .. import ndarray
from ..io.io import DataDesc

__all__ = ["DataParallelExecutorGroup"]


def _split_input_slice(batch_size, work_load_list):
    total = sum(work_load_list)
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * w / total))
        slices.append(slice(start, end))
        start = end
    return slices


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write", state_names=None, group2ctxs=None,
                 remat_policy=None, fusion=None, aot=None,
                 dtype_policy=None):
        self.symbol = symbol
        self.remat_policy = remat_policy
        self.fusion = fusion
        self.aot = aot
        self.dtype_policy = dtype_policy
        self.contexts = contexts
        self.workload = workload or [1] * len(contexts)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.param_names = param_names
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []
        self.logger = logger
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.execs = []
        self.data_shapes = None
        self.label_shapes = None
        self.batch_size = None
        self.slices = None

        if grad_req == "write":
            self.grad_req = {}
            for name in self.arg_names:
                if name in self.param_names:
                    self.grad_req[name] = "null" \
                        if name in self.fixed_param_names else "write"
                elif inputs_need_grad and any(
                        name == d.name for d in data_shapes):
                    self.grad_req[name] = "write"
                else:
                    self.grad_req[name] = "null"
        else:
            self.grad_req = grad_req
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        self.data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                            for d in data_shapes]
        self.label_shapes = ([l if isinstance(l, DataDesc) else DataDesc(*l)
                              for l in label_shapes]
                             if label_shapes else None)
        self.batch_size = self.data_shapes[0].shape[0]
        self.slices = _split_input_slice(self.batch_size, self.workload)
        self.execs = []
        for i, ctx in enumerate(self.contexts):
            islice = self.slices[i]
            n = islice.stop - islice.start
            shapes = {}
            for d in self.data_shapes:
                shapes[d.name] = (n,) + tuple(d.shape[1:])
            if self.label_shapes:
                for l in self.label_shapes:
                    shapes[l.name] = (n,) + tuple(l.shape[1:])
            shared = shared_group.execs[i] if shared_group else None
            exe = self.symbol.simple_bind(ctx=ctx, grad_req=self.grad_req,
                                          shared_exec=shared,
                                          remat_policy=self.remat_policy,
                                          fusion=self.fusion,
                                          aot=self.aot,
                                          dtype_policy=self.dtype_policy,
                                          **shapes)
            self.execs.append(exe)

    # -- param flow ------------------------------------------------------
    def set_params(self, arg_params, aux_params, allow_extra=False):
        for exe in self.execs:
            exe.copy_params_from(arg_params, aux_params,
                                 allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        for name in self.param_names:
            if name not in self.execs[0].arg_dict:
                continue
            weight = self.execs[0].arg_dict[name]
            if len(self.execs) > 1:
                acc = weight.copy()
                for exe in self.execs[1:]:
                    acc += exe.arg_dict[name]
                weight = acc / len(self.execs)
            if name in arg_params:
                weight.astype(arg_params[name].dtype).copyto(arg_params[name])
            else:
                arg_params[name] = weight.copy()
        for name in self.aux_names:
            aux = self.execs[0].aux_dict[name]
            if name in aux_params:
                aux.astype(aux_params[name].dtype).copyto(aux_params[name])
            else:
                aux_params[name] = aux.copy()

    # -- execution -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        data = data_batch.data
        labels = getattr(data_batch, "label", None)
        for i, exe in enumerate(self.execs):
            islice = self.slices[i]
            feed = {}
            for d, arr in zip(self.data_shapes, data):
                feed[d.name] = arr[islice] if len(self.execs) > 1 else arr
            if self.label_shapes and labels is not None:
                for l, arr in zip(self.label_shapes, labels):
                    feed[l.name] = arr[islice] if len(self.execs) > 1 else arr
            exe.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        assert self.for_training, "re-bind with for_training=True to run "\
            "backward"
        for i, exe in enumerate(self.execs):
            exe.backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True, begin=0, end=None):
        if end is None:
            end = len(self.execs[0]._out_names)
        outputs = [[exe.outputs[i] for exe in self.execs]
                   for i in range(begin, end)]
        if merge_multi_context:
            return [outs[0] if len(outs) == 1 else ndarray.concatenate(outs)
                    for outs in outputs]
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        grads = [[exe.grad_dict[d.name] for exe in self.execs]
                 for d in self.data_shapes]
        if merge_multi_context:
            return [g[0] if len(g) == 1 else ndarray.concatenate(g)
                    for g in grads]
        return grads

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for i, exe in enumerate(self.execs):
            labels_slice = []
            for label in labels:
                if len(self.execs) > 1 and not pre_sliced:
                    labels_slice.append(label[self.slices[i]])
                else:
                    labels_slice.append(label)
            preds = exe.outputs
            eval_metric.update_dict(
                dict(zip([l.name for l in (self.label_shapes or [])]
                         or ["label"], labels_slice)),
                dict(zip(exe._out_names, preds)))

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)
