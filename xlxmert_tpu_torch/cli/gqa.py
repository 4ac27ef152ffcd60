"""gqa finetune/eval CLI (reference tasks/gqa.py __main__)."""
from xlxmert_tpu_torch.cli.finetune import run


def main(argv=None):
    run("gqa", argv)


if __name__ == "__main__":
    main()
