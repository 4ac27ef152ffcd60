"""Per-task evaluators + leaderboard dump formats (the port's copy of
xlxmert_tpu/data/evaluators.py).

These are the reference's accuracy oracles (SURVEY.md §4): VQA soft-score
accuracy (vqa_data.py:265-298), GQA accuracy + challenge json
(gqa_data.py:249-284), NLVR2 exact-match + CSV (nlvr2_data.py:198-225),
pretraining QA accuracy (lxmert_data.py:769-843).
"""
from __future__ import annotations

import json
from typing import Dict, Mapping


class VQAEvaluator:
    """`id2datum[qid]['label']` is a {answer: soft score} dict."""

    def __init__(self, id2datum: Mapping[object, dict]):
        self.id2datum = id2datum

    def evaluate(self, quesid2ans: Dict) -> float:
        score = 0.0
        for quesid, ans in quesid2ans.items():
            label = self.id2datum[quesid]["label"]
            if ans in label:
                score += label[ans]
        return score / len(quesid2ans)

    def dump_result(self, quesid2ans: Dict, path: str) -> None:
        """VQA leaderboard json (vqa_data.py:278-298)."""
        with open(path, "w") as f:
            json.dump(
                [{"question_id": qid, "answer": ans}
                 for qid, ans in quesid2ans.items()],
                f, indent=4, sort_keys=True)

    def oracle_score(self, quesid2targets: Mapping) -> float:
        """Upper bound: max soft score per question (tasks/vqa.py:302-315)."""
        score = 0.0
        for quesid in quesid2targets:
            label = self.id2datum[quesid]["label"]
            if label:
                score += max(label.values())
        return score / max(len(quesid2targets), 1)


class GQAEvaluator(VQAEvaluator):
    def dump_result(self, quesid2ans: Dict, path: str) -> None:
        """GQA challenge json (gqa_data.py:262-284). questionId must be str."""
        with open(path, "w") as f:
            json.dump(
                [{"questionId": str(qid), "prediction": ans}
                 for qid, ans in quesid2ans.items()],
                f, indent=4, sort_keys=True)


class NLVR2Evaluator:
    """Exact-match accuracy over {0,1} labels (nlvr2_data.py:198-225)."""

    def __init__(self, id2datum: Mapping[object, dict]):
        self.id2datum = id2datum

    def evaluate(self, quesid2ans: Dict) -> float:
        score = 0.0
        for quesid, ans in quesid2ans.items():
            if ans == self.id2datum[quesid]["label"]:
                score += 1
        return score / len(quesid2ans)

    def dump_result(self, quesid2ans: Dict, path: str) -> None:
        """NLVR2 CSV: identifier,True/False (nlvr2_data.py:211-225)."""
        with open(path, "w") as f:
            for uid, ans in quesid2ans.items():
                idt = self.id2datum[uid]["identifier"]
                f.write("%s,%s\n" % (idt, "True" if ans == 1 else "False"))

    def confusion(self, quesid2ans: Dict) -> Dict[str, int]:
        """TP/FN/FP/TN tally (reference nlvr2.py:210-220)."""
        out = {"TP": 0, "FN": 0, "FP": 0, "TN": 0}
        for quesid, ans in quesid2ans.items():
            label = self.id2datum[quesid]["label"]
            if label == 1:
                out["TP" if ans == 1 else "FN"] += 1
            else:
                out["FP" if ans == 1 else "TN"] += 1
        return out


class QAEvaluator:
    """Pretraining QA accuracy over the 9500-answer table
    (lxmert_data.py:769-843): per-uid correctness vs the sampled answer."""

    def __init__(self, uid2ans: Mapping[object, str]):
        self.uid2ans = dict(uid2ans)

    def evaluate(self, uid2pred: Dict) -> float:
        score = 0.0
        n = 0
        for uid, pred in uid2pred.items():
            if uid in self.uid2ans:
                n += 1
                if pred == self.uid2ans[uid]:
                    score += 1
        return score / max(n, 1)
