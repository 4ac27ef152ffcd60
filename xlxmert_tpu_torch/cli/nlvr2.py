"""nlvr2 finetune/eval CLI (reference tasks/nlvr2.py __main__)."""
from xlxmert_tpu_torch.cli.finetune import run


def main(argv=None):
    run("nlvr2", argv)


if __name__ == "__main__":
    main()
