"""QA answer vocabulary + pretrain->finetune answer-head surgery (the
port's copy of xlxmert_tpu/data/answer_table.py).

Reference: x-lxmert/src/pretrain/qa_answer_table.py:11-142. The pretrain QA
head covers a 9500-answer vocabulary; finetuning re-maps its output rows
onto the task's own answer vocab (rows for unseen answers are zeroed).
Here the surgery operates on flax param pytrees instead of state_dicts.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Union

import numpy as np

ANS_CONVERT = {
    "a man": "man", "the man": "man",
    "a woman": "woman", "the woman": "woman",
    "one": "1", "two": "2", "three": "3", "four": "4", "five": "5",
    "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
    "grey": "gray",
}


def convert_ans(ans: str) -> str:
    """Normalize an answer string (qa_answer_table.py:54-68)."""
    if len(ans) == 0:
        return ""
    ans = ans.lower()
    if ans[-1] == ".":
        ans = ans[:-1].strip()
    for prefix in ("a ", "an ", "the "):
        if ans.startswith(prefix):
            ans = ans[len(prefix):].strip()
            break
    return ANS_CONVERT.get(ans, ans)


class AnswerTable:
    """9500-answer pretraining vocabulary (qa_answer_table.py:11-90).

    `all_ans` entries: {"ans": str, "dsets": [..]} loaded from
    data/lxmert/all_ans.json, or passed directly for tests.
    """

    def __init__(self, all_ans: Union[str, Path, List[dict]],
                 dsets: Optional[List[str]] = None):
        if isinstance(all_ans, (str, Path)):
            with open(all_ans) as f:
                all_ans = json.load(f)
        if dsets is not None:
            dset_set = set(dsets)
            self.anss = [a["ans"] for a in all_ans
                         if set(a["dsets"]) & dset_set]
        else:
            self.anss = [a["ans"] for a in all_ans]
        self.ans_set = set(self.anss)
        self._ans2id = {a: i for i, a in enumerate(self.anss)}

    def convert_ans(self, ans: str) -> str:
        return convert_ans(ans)

    def ans2id(self, ans: str) -> int:
        return self._ans2id[ans]

    def id2ans(self, i: int) -> str:
        return self.anss[i]

    def used(self, ans: str) -> bool:
        return ans in self.ans_set

    @property
    def num_answers(self) -> int:
        return len(self.anss)


def surgery_answer_head(
    pretrain_params: Mapping,
    finetune_params: Mapping,
    answer_table: AnswerTable,
    label2ans: Union[Dict[int, str], List[str]],
) -> Dict:
    """Re-map pretrain QA-head output rows onto the finetune answer vocab
    (qa_answer_table.py:93-142). Returns updated finetune head params
    {'logit_fc_3': {'kernel', 'bias'}} and a (loaded, unloaded) count.

    Flax kernels are (in, out), so "rows" of the torch weight are columns
    of the kernel.
    """
    src = pretrain_params["answer_head"]["logit_fc_3"]
    dst = finetune_params["answer_head"]["logit_fc_3"]
    kernel = np.array(dst["kernel"])  # (in, n_labels)
    bias = np.array(dst["bias"])

    if isinstance(label2ans, list):
        label2ans = dict(enumerate(label2ans))

    loaded = unload = 0
    for label, ans in label2ans.items():
        new_ans = answer_table.convert_ans(ans)
        if answer_table.used(new_ans):
            src_id = answer_table.ans2id(new_ans)
            kernel[:, label] = np.asarray(src["kernel"])[:, src_id]
            bias[label] = np.asarray(src["bias"])[src_id]
            loaded += 1
        else:
            kernel[:, label] = 0.0
            bias[label] = 0.0
            unload += 1

    out = dict(finetune_params)
    head = dict(out["answer_head"])
    head["logit_fc_3"] = {"kernel": kernel, "bias": bias}
    out["answer_head"] = head
    return out, (loaded, unload)
